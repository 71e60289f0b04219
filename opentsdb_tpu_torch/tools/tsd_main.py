"""Daemon entry point: ``python -m opentsdb_tpu_torch.tools.tsd_main``.

Port of opentsdb_tpu/tools/tsd_main.py (OpenTSDB src/tools/TSDMain.java
:71): parse the flags and the config, build the TSDB on the card (the
default device; with no CUDA device this raises, as every entry point of
the port does), start the maintenance thread, bind the server and serve
until SIGTERM or SIGINT, which take the graceful path.

    python -m opentsdb_tpu_torch.tools.tsd_main --port 4242 \\
        [--bind ADDR] [--config FILE] [--mode rw|ro|wo] [--auto-metric] \\
        [--worker-threads N]
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tsd_main", description="Start the TSD (time series daemon)")
    p.add_argument("--port", type=int, default=None,
                   help="TCP port to listen on (tsd.network.port)")
    p.add_argument("--bind", default=None,
                   help="Address to bind to (tsd.network.bind)")
    p.add_argument("--config", default=None,
                   help="Path to a configuration file (key = value lines)")
    p.add_argument("--mode", default=None, choices=["rw", "ro", "wo"],
                   help="Operation mode (tsd.mode)")
    p.add_argument("--auto-metric", action="store_true", default=None,
                   help="Automatically add metrics "
                        "(tsd.core.auto_create_metrics)")
    p.add_argument("--worker-threads", type=int, default=8,
                   help="Responder thread pool size")
    return p


def make_config_from_args(args):
    from opentsdb_tpu_torch.utils.config import Config, refuse_unported
    config = Config()
    if args.config:
        config.load_file(args.config)
    if args.mode:
        config.override_config("tsd.mode", args.mode)
    if args.auto_metric:
        config.override_config("tsd.core.auto_create_metrics", "true")
    if args.port is not None:
        config.override_config("tsd.network.port", str(args.port))
    if args.bind:
        config.override_config("tsd.network.bind", args.bind)
    refuse_unported(config)
    return config


def main(argv: list[str] | None = None) -> int:
    args = build_arg_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [%(threadName)s] "
               "%(name)s: %(message)s")
    try:
        config = make_config_from_args(args)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    port_cfg = config.get_string("tsd.network.port")
    if not port_cfg:
        print("Missing network port (--port or tsd.network.port)",
              file=sys.stderr)
        return 1
    from opentsdb_tpu_torch.core import TSDB
    from opentsdb_tpu_torch.tsd.server import TSDServer
    tsdb = TSDB(config)
    tsdb.start_maintenance()
    server = TSDServer(tsdb, port=int(port_cfg),
                       bind=config.get_string("tsd.network.bind"),
                       worker_threads=args.worker_threads)

    async def run():
        await server.start()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, server.request_shutdown)
        await server.serve_forever()

    asyncio.run(run())
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Command-line entry points of opentsdb_tpu_torch."""

"""The mesh's collectives: sum, min and max reductions to a root, the
gather of row blocks to the owner, and the broadcast from the owner.

The port's counterpart of the reference's ``lax.psum`` / ``pmin`` /
``pmax`` / ``all_gather`` over ICI (opentsdb_tpu/parallel/sharded.py).
One process drives every device of the mesh, as JAX's single controller
does.  The backend follows the placement and is fixed when the mesh is
built:

* every shard on a CUDA device of its own: NCCL through
  ``torch.cuda.nccl`` (``reduce``, ``all_gather``, ``broadcast``; SUM, MIN
  and MAX on f64 and int64), a one-device mesh on one card included;
* every shard on the same device (the CPU tests, the one-card chip
  check's virtual mesh): the partials are reduced on that device, in
  shard order;
* anything else (a mix, or NCCL missing for distinct CUDA devices):
  refused.  Neither backend ever stands in for the other.

Results stay on the root (the owner for a whole-mesh reduce), where the
reference replicates them on every chip.
"""

from __future__ import annotations

import torch

# ncclRedOp_t values (nccl.h): torch.cuda.nccl names only SUM.
NCCL_OPS = {"sum": 0, "max": 2, "min": 3}
BACKENDS = ("nccl", "shared")


def nccl_module():
    """torch.cuda.nccl when this torch build has NCCL, else None."""
    try:
        import torch.cuda.nccl as nccl
        nccl.version()
    except (ImportError, AttributeError, RuntimeError):
        return None
    return nccl


class Collectives:
    """The collectives of one mesh's devices (flat, shard order)."""

    def __init__(self, devices):
        self.devices = list(devices)
        distinct = len(set(self.devices)) == len(self.devices)
        if distinct and all(d.type == "cuda" for d in self.devices):
            self._nccl = nccl_module()
            if self._nccl is None:
                raise ValueError(
                    "a mesh of distinct CUDA devices combines through NCCL, "
                    "which this torch build lacks")
            self.backend = "nccl"
        elif len(set(self.devices)) == 1:
            self._nccl = None
            self.backend = "shared"
        else:
            raise ValueError(
                "a mesh puts every shard on one device or each on a CUDA "
                "device of its own, not %s"
                % ", ".join(str(d) for d in self.devices))

    def _members(self, members) -> list[int]:
        return list(range(len(self.devices))) if members is None \
            else list(members)

    def reduce(self, parts: list, op: str, members=None) -> torch.Tensor:
        """`op` ("sum", "min" or "max") over `parts`, one tensor of one
        shape a member (every shard when `members` is None, else those
        shard indices, each part on its shard's device) -> the result on
        the first member's device."""
        members = self._members(members)
        if op not in NCCL_OPS or len(parts) != len(members) or not parts:
            raise ValueError("reduce takes one part a member and an op of "
                             "sum, min or max")
        if self.backend == "shared":
            out = parts[0].clone()
            for p in parts[1:]:
                if op == "sum":
                    out.add_(p)
                elif op == "min":
                    torch.minimum(out, p, out=out)
                else:
                    torch.maximum(out, p, out=out)
            return out
        inputs = [p.contiguous() for p in parts]
        self._check_placed(inputs, members)
        out = torch.empty_like(inputs[0])
        self._nccl.reduce(inputs, output=out, root=0, op=NCCL_OPS[op])
        return out

    def all_gather(self, parts: list) -> torch.Tensor:
        """Every shard's row block (dim 0, any length) concatenated in
        shard order on the owner."""
        if len(parts) != len(self.devices):
            raise ValueError("all_gather takes one part a shard")
        if self.backend == "shared":
            return torch.cat(parts, dim=0)
        rows = max(p.shape[0] for p in parts)
        rest = tuple(parts[0].shape[1:])
        if rows == 0:
            return torch.cat([p.to(self.devices[0]) for p in parts], dim=0)
        inputs = []
        for p in parts:
            buf = torch.zeros((rows,) + rest, dtype=p.dtype, device=p.device)
            buf[:p.shape[0]] = p
            inputs.append(buf)
        self._check_placed(inputs, self._members(None))
        outputs = [torch.empty((len(parts) * rows,) + rest, dtype=p.dtype,
                               device=d)
                   for p, d in zip(inputs, self.devices)]
        self._nccl.all_gather(inputs, outputs)
        blocks = outputs[0].view((len(parts), rows) + rest)
        return torch.cat([blocks[k, :p.shape[0]]
                          for k, p in enumerate(parts)], dim=0)

    def broadcast(self, tensor: torch.Tensor) -> list:
        """`tensor` (on the owner) on every shard's device, in shard
        order; on a shared device every entry is `tensor` itself."""
        if self.backend == "shared":
            return [tensor] * len(self.devices)
        tensor = tensor.contiguous()
        bufs = [tensor] + [torch.empty_like(tensor, device=d)
                           for d in self.devices[1:]]
        self._check_placed(bufs, self._members(None))
        self._nccl.broadcast(bufs, root=0)
        return bufs

    def _check_placed(self, tensors, members) -> None:
        for t, i in zip(tensors, members):
            if t.device != self.devices[i]:
                raise ValueError("shard %d's part lies on %s, not on its "
                                 "device %s" % (i, t.device, self.devices[i]))

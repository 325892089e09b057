"""Named, deterministic random streams, counterpart of
``cnn_tpu/core/rng.py``.

``cnn_tpu`` derives a JAX key per (name, step) from one root seed by
``fold_in``; the port derives a ``torch.Generator`` the same way. The
streams cannot match threefry's bits (the port draws from Philox / the
Mersenne Twister), so parity goes through drawn parameters and
checkpoints, never fresh draws; what carries over is the discipline: one
seed, a stream per name, stable across processes.
"""

from __future__ import annotations

import hashlib
import zlib

import torch

from cnn_tpu_torch import default_device


class RngStream:
    """Deterministic named generators from one root seed, on ``device``
    (None: the card, ``cnn_tpu_torch.default_device``)."""

    def __init__(self, seed: int, device=None):
        self.seed = int(seed)
        self.device = default_device(device)

    def seed_of(self, name: str, step: int = 0) -> int:
        """The seed of stream ``name`` at ``step``.

        It folds in, as ``cnn_tpu``'s key does, the root seed, then
        ``zlib.crc32(name.encode()) & 0x7FFFFFFF`` (stable across
        processes, unlike ``hash()``), then ``step`` where it is not 0: the
        first 8 bytes, little-endian, of the SHA-256 of the three as signed
        64-bit little-endian integers (two where ``step`` is 0), masked to
        63 bits. Equal arguments give equal seeds; another name or step,
        another seed.
        """
        folds = [self.seed, zlib.crc32(name.encode()) & 0x7FFFFFFF]
        if step:
            folds.append(int(step))
        data = b"".join(v.to_bytes(8, "little", signed=True) for v in folds)
        return int.from_bytes(hashlib.sha256(data).digest()[:8],
                              "little") & 0x7FFFFFFFFFFFFFFF

    def key(self, name: str, step: int = 0) -> torch.Generator:
        """A new generator for stream ``name`` at ``step``, seeded with
        ``seed_of(name, step)``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed_of(name, step))
        return gen

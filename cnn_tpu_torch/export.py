"""Serving artifacts: the inference program and its weights as one file,
counterpart of ``cnn_tpu/export.py``.

``cnn_tpu`` serializes its lowered program (StableHLO, through
``jax.export``), which this package cannot run. Its counterpart here is a
``torch.export`` program of the same function, ``uint8 [b,H,W,3] ->
(labels, probs)`` (``serving.bucket_forward``), with the batch ``b`` a
symbolic ``torch.export.Dim`` and the weights embedded, so that serving
needs no model class and no checkpoint:

- **one artifact, any batch size**: the engine's buckets still apply
  (``InferenceEngine.from_artifact``);
- **the kernels by name**: ``torch.export`` cannot trace a ctypes launch,
  so every kernel the served forward reaches is recorded as its operator
  (``torch.ops.cnn_tpu_torch.uint8_normalize``, ``conv2d_bias_relu``,
  ``max_pool2d_fwd``), whose CUDA implementation is the kernel and whose
  CPU implementation is the plain version. Loading an artifact therefore
  needs ``import cnn_tpu_torch`` (this module registers the operators),
  where ``cnn_tpu``'s needs only jax;
- **both devices**: ``platforms`` (``["cuda", "cpu"]`` by default) lists
  the devices it may be loaded on; a program traced on one device is moved
  to the other at load (``torch.export.passes.move_to_device_pass``);
- **quantization-transparent**: pass ``int8_calib`` and the program is
  the BN-folded int8 graph (``quant.py``); pass a folded model to export
  the folded float32 graph.

File format, ``cnn_tpu``'s container: ``b"CTSA"``, a u32 little-endian
header length, the JSON header (``cnn_tpu``'s keys, with ``"format":
"cnn_tpu_torch-serving-artifact"``), then the ``torch.export.save``
payload.
"""

from __future__ import annotations

import io
import json
import struct

import numpy as np
import torch
from torch import nn

import cnn_tpu_torch.ops.hopper  # noqa: F401  (registers the operators)
from cnn_tpu_torch import default_device
from cnn_tpu_torch.ops.linear import full_precision_reduction

_MAGIC = b"CTSA"
FORMAT = "cnn_tpu_torch-serving-artifact"
JAX_FORMAT = "cnn_tpu-serving-artifact"     # cnn_tpu's StableHLO artifacts


class ServingProgram(nn.Module):
    """``serving.bucket_forward`` of ``model`` as the module exported."""

    def __init__(self, model, compute_dtype=None):
        super().__init__()
        self.model = model
        self.compute_dtype = compute_dtype

    def forward(self, images_u8):
        from cnn_tpu_torch.serving import bucket_forward
        return bucket_forward(self.model, images_u8, self.compute_dtype)


def export_serving_artifact(model, path: str, *, compute_dtype=None,
                            int8_calib=None, platforms=("cuda", "cpu"),
                            class_names=None) -> dict:
    """Writes the inference program of ``model`` (on its device) to
    ``path``; returns the header, which the file holds too.

    Raises ``ValueError`` for a model with an MoE block (MoECNN): its
    expert capacity ``int(capacity_factor * B / n_experts)`` is a float
    floor of the batch, which ``torch.export`` cannot keep symbolic (it
    fixes the capacity at the example batch's value), and a program for
    one batch is not what an artifact promises."""
    from cnn_tpu_torch.nn.moe import MoEBlock
    if any(isinstance(m, MoEBlock) for m in model.modules()):
        raise ValueError(
            "export_serving_artifact: a model with an MoE block cannot be "
            "exported with a symbolic batch: its expert capacity, "
            "int(capacity_factor * B / n_experts), is a float floor of the "
            "batch, which torch.export fixes at the example batch's value")
    net = model.eval()
    if int8_calib is not None:
        from cnn_tpu_torch.quant import QuantizedModel, quantize_int8
        net = QuantizedModel(*quantize_int8(model, int8_calib))
    program = ServingProgram(net, compute_dtype).eval()
    s = int(model.image_size)
    example = torch.zeros((2, s, s, 3), dtype=torch.uint8,
                          device=next(model.parameters()).device)
    with torch.no_grad():
        exported = torch.export.export(
            program, (example,),
            dynamic_shapes=({0: torch.export.Dim("b", min=1)},))
    payload = io.BytesIO()
    torch.export.save(exported, payload)

    meta = {
        "format": FORMAT,
        "version": 1,
        "image_size": s,
        "num_classes": int(getattr(model, "num_classes", 0)) or None,
        "class_names": list(class_names) if class_names else None,
        "platforms": list(platforms),
        "int8": int8_calib is not None,
        "compute_dtype": str(compute_dtype).removeprefix("torch.")
        if compute_dtype is not None else None,
    }
    header = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(payload.getvalue())
    return meta


def _program_device(exported) -> torch.device | None:
    for t in (*exported.state_dict.values(), *exported.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    return None


class ServingArtifact:
    """A loaded serving program: ``uint8 [N,H,W,3] -> (labels, probs)`` on
    ``device``. Needs ``cnn_tpu_torch`` (its operators), no model class and
    no checkpoint."""

    def __init__(self, meta: dict, exported, device: torch.device):
        self.meta = meta
        self.device = device
        self._program = exported.module()

    @classmethod
    def load(cls, path: str, device=None) -> "ServingArtifact":
        """Reads ``path`` onto ``device`` (default: the GPU). Refuses a file
        without the magic, ``cnn_tpu``'s StableHLO artifacts and a device
        outside the header's ``platforms``."""
        dev = default_device(device)
        with open(path, "rb") as f:
            magic = f.read(4)
            if magic != _MAGIC:
                raise ValueError(f"{path}: not a cnn_tpu serving artifact "
                                 f"(magic {magic!r})")
            (hlen,) = struct.unpack("<I", f.read(4))
            meta = json.loads(f.read(hlen).decode())
            payload = f.read()
        if meta.get("format") == JAX_FORMAT:
            raise ValueError(
                f"{path}: a StableHLO artifact of the JAX package (cnn_tpu), "
                "which only jax can run; export one for this package with "
                "cnn_tpu_torch.tools.export_artifact")
        if meta.get("format") != FORMAT:
            raise ValueError(f"{path}: unknown artifact format "
                             f"{meta.get('format')!r}")
        if dev.type not in meta["platforms"]:
            raise ValueError(f"{path}: exported for {meta['platforms']}, "
                             f"not {dev.type}")
        exported = torch.export.load(io.BytesIO(payload))
        if _program_device(exported) not in (None, dev):
            from torch.export.passes import move_to_device_pass
            exported = move_to_device_pass(exported, dev)
        return cls(meta, exported, dev)

    @property
    def image_size(self) -> int:
        return self.meta["image_size"]

    def __call__(self, images_u8) -> tuple[torch.Tensor, torch.Tensor]:
        images = torch.as_tensor(images_u8).to(self.device)
        # the program records the eager layers' aten ops but not the
        # switches they set around them, process-wide: bf16 products that
        # sum in float32 (ops/linear.py:full_precision_reduction) and the
        # depthwise conv's cuDNN flags (ops/conv.py:DepthwiseConvFn); the
        # call sets both, as the layers do
        with torch.no_grad(), full_precision_reduction(), \
                torch.backends.cudnn.flags(allow_tf32=False):
            return self._program(images)

    def predict(self, images_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        labels, probs = self(images_u8)
        return labels.cpu().numpy(), probs.cpu().numpy()

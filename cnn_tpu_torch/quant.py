"""Post-training quantization for serving, counterpart of ``cnn_tpu/quant.py``:
BatchNorm folding and int8.

1. **BatchNorm folding** (``fold_batchnorm``). At inference BN is an affine
   map with frozen moving statistics, so it folds into the conv before it:
   ``inv = gamma / sqrt(var + eps)``, ``w' = w * inv``, ``b' = (b - mean) *
   inv + beta``, in float32 and in that order, as ``cnn_tpu`` computes it.
   The folded model (``FoldedModel``) has no BN layer and no state; every
   other layer keeps its name, so capture (Grad-CAM) and ``tree_leaves``
   still address it. A conv that was conv -> BN -> ReLU is conv -> ReLU
   there, which ``nn/sequential.py:fuses`` runs as one ``relu=True`` conv
   launch, in a ResidualBlock's body and in a StackedBlocks trunk alike.

2. **int8** (``quantize_int8``, ``quantized_apply``). Weights quantize
   per output channel, symmetric (absmax / 127); activations per layer,
   symmetric, with scales from a calibration batch (absmax / 127 of each
   conv's or dense layer's input; a trunk's per block). Each conv and the
   dense head multiply s8 x s8 into exact int32 accumulators, then
   ``acc * (in_scale * w_scale) + b`` in float32; ReLU, the pools, the
   MoE block (its float32 expert bank) and the rest run in float32 on the
   kernels and plain ops, as ``quantized_apply`` does in ``cnn_tpu``.

The s8 x s8 -> s32 products: ``cnn_tpu`` leaves them to XLA
(``lax.conv_general_dilated`` and ``lax.dot_general`` with an int32
result), outside any Pallas kernel, so here they are library products.
A dense conv is an NHWC im2col times the [k*k*Cin, Cout] weights through
``torch._int_mm`` (cuBLASLt on CUDA), with 16 zero rows below the
columns (cuBLASLt's int8 product wants more than 16 rows) and K and N
padded with zeros to multiples of 8; zero padding adds nothing, so the
accumulators are exact. A depthwise conv sums its k*k taps as int32
products (``_depthwise_s32``). A float32 accumulation of a dense conv
would not be exact: K * 127^2 passes 2^24 above K = 1040 (VGG's 3x3x512,
AlexNet's 4,608-wide head).

Calibration scales stay device tensors: no layer's scale is read back to
the host.

Layers hold their own weights here, so where ``cnn_tpu`` takes ``(model,
params, state)`` these functions take the model.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from cnn_tpu_torch.models.base import SequentialModel
from cnn_tpu_torch.nn.module import (BatchNorm2D, Conv2D, DepthwiseConv2D,
                                     Linear, ResidualBlock, StackedBlocks)
from cnn_tpu_torch.nn.sequential import Sequential
from cnn_tpu_torch.ops.conv import conv_out_size
from cnn_tpu_torch.ops.hopper.normalize import uint8_normalize

MM_ROWS_PAD = 16    # zero rows under every int8 product: cuBLASLt wants M > 16
MM_ALIGN = 8        # K and N of an int8 product: multiples of 8


class FoldedModel(SequentialModel):
    """A model-shaped view (``net``, ``image_size``, ``num_classes``,
    ``forward``) over folded layers; eval only."""

    def __init__(self, net: Sequential, image_size: int, num_classes: int):
        super().__init__(num_classes, image_size)
        self.net = net


def _has_state(layer) -> bool:
    return any(is_state for _, _, is_state in layer.tree_leaves())


def _has_params(layer) -> bool:
    return any(True for _ in layer.parameters(recurse=False))


def _fold_conv_bn(conv, bn):
    """The folded copy of ``conv`` (a Conv2D, or a DepthwiseConv2D, whose
    bank's last axis is its out channels too)."""
    folded = copy.deepcopy(conv)
    with torch.no_grad():
        # the float32 square root correctly rounded, as XLA's: taken in
        # float64 and rounded once (exact for a float32 input), where
        # PyTorch's vectorised CPU sqrt can be an ulp off
        inv = bn.gamma / torch.sqrt((bn.var + bn.eps).double()).float()
        folded.w.copy_(conv.w * inv)
        folded.b.copy_((conv.b - bn.mean) * inv + bn.beta)
    return folded


def _fold_layer_list(layers) -> list:
    """Fold (Depthwise)Conv2D -> BatchNorm2D pairs in a flat layer list;
    recurse into residual blocks (the projection shortcut, a bare conv,
    passes through) and stacked trunks (block by block)."""
    out, i = [], 0
    while i < len(layers):
        layer = layers[i]
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        if (isinstance(layer, (Conv2D, DepthwiseConv2D))
                and isinstance(nxt, BatchNorm2D)):
            out.append(_fold_conv_bn(layer, nxt))
            i += 2
            continue
        if isinstance(layer, ResidualBlock):
            out.append(_fold_block(layer))
        elif isinstance(layer, StackedBlocks):
            if layer.block.proj is not None:
                raise ValueError("projection shortcuts not supported")
            blocks = [_fold_block(layer.block_at(j))
                      for j in range(layer.n_blocks)]
            # the quantized trunk runs body layers without params except
            # convs: any other parameterized layer would lose its params
            bad = [l.name for l in blocks[0].body
                   if _has_params(l) and not isinstance(l, Conv2D)]
            if bad:
                raise ValueError(f"unsupported parameterized body layers "
                                 f"in quantized trunk: {bad}")
            out.append(StackedBlocks(layer.name, blocks, remat=layer.remat))
        elif _has_state(layer) and getattr(layer, "state_eval_inert", False):
            # monitoring-only state (MoEBlock's expert loads) is never read
            # by the forward: keep the layer and its params, drop the state
            kept = copy.deepcopy(layer)
            for key in list(kept._buffers):
                del kept._buffers[key]
            out.append(kept)
        elif _has_state(layer):
            raise ValueError(
                f"cannot fold stateful layer {layer.name} "
                f"({type(layer).__name__}) — only Conv2D->BatchNorm2D pairs")
        else:
            out.append(copy.deepcopy(layer))
        i += 1
    return out


def _fold_block(block: ResidualBlock) -> ResidualBlock:
    """The block with its body folded; the projection shortcut, a bare
    conv with no BN after it, is copied as it is."""
    return ResidualBlock(block.name,
                         Sequential(_fold_layer_list(list(block.body))),
                         proj=copy.deepcopy(block.proj))


def fold_batchnorm(model) -> FoldedModel:
    """Fold every Conv2D -> BatchNorm2D pair (inside residual blocks and
    stacked trunks too) and drop the BN layers; the result holds folded
    float32 copies of the weights, on the model's device, and no state."""
    folded = FoldedModel(Sequential(_fold_layer_list(list(model.net))),
                         model.image_size, model.num_classes)
    return folded.eval()


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 0-d tensor on ``like``'s device: on CUDA a
    division by a host number becomes a reciprocal multiply (``ops/
    preprocess.py``), which would move scales by an ulp."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _quantize_weight(w: torch.Tensor, axis: int):
    """Symmetric per-output-channel int8: ``(q_w, scale[out])``."""
    reduce = tuple(a for a in range(w.dim()) if a != axis)
    absmax = w.detach().abs().amax(dim=reduce)
    scale = torch.clamp_min(absmax, 1e-12) / _const(127.0, w)
    shape = [1] * w.dim()
    shape[axis] = -1
    q = torch.clamp(torch.round(w.detach() / scale.reshape(shape)), -127, 127)
    return q.to(torch.int8), scale


def _quantize_weight_stacked(w: torch.Tensor):
    """Per-(block, output-channel) symmetric int8 for ``[L, ..., out]``."""
    absmax = w.detach().abs().amax(dim=tuple(range(1, w.dim() - 1)))
    scale = torch.clamp_min(absmax, 1e-12) / _const(127.0, w)
    shape = (w.shape[0],) + (1,) * (w.dim() - 2) + (w.shape[-1],)
    q = torch.clamp(torch.round(w.detach() / scale.reshape(shape)), -127, 127)
    return q.to(torch.int8), scale


def _scale_of(x: torch.Tensor) -> torch.Tensor:
    """absmax / 127 as a device scalar (no host read)."""
    return torch.clamp_min(x.abs().amax().float() / _const(127.0, x), 1e-12)


def _trunk_calibrate(trunk: StackedBlocks, h: torch.Tensor) -> dict:
    """Each block's input scale for every conv of the (folded, BN-free)
    trunk, walked block by block over the calibration activations:
    ``{conv_name: [L]}``."""
    scales = {l.name: [] for l in trunk.block.body if isinstance(l, Conv2D)}
    for i in range(trunk.n_blocks):
        x = h
        for l in trunk.block_at(i).body:
            if isinstance(l, Conv2D):
                scales[l.name].append(x.abs().amax() / _const(127.0, x))
            x = l(x)
        h = ResidualBlock.combine(x, h)
    return {k: torch.clamp_min(torch.stack(v).float(), 1e-12)
            for k, v in scales.items()}


def _block_calibrate(block: ResidualBlock, x: torch.Tensor) -> dict:
    """Per-conv input scales inside a (folded, BN-free) residual block; the
    projection shortcut sees the block input."""
    scales, h = {}, x
    for l in block.body:
        if isinstance(l, Conv2D):
            scales[l.name] = _scale_of(h)
        h = l(h)
    if block.proj is not None:
        scales[block.proj.name] = _scale_of(x)
    return scales


def calibrate_activation_scales(model, images_u8) -> dict:
    """Per-layer input absmax / 127 over a calibration batch of uint8
    images: one captured forward gives every top-level layer's input (layer
    0 sees the /255-normalized images); residual blocks and stacked trunks
    are walked to give each inner conv (each block's) its own."""
    net = model.net
    x = uint8_normalize(torch.as_tensor(images_u8).to(
        next(model.parameters()).device))
    with torch.no_grad():
        _, acts = net(x, capture=[l.name for l in net])
        scales, prev = {}, x
        for layer in net:
            if isinstance(layer, (Conv2D, DepthwiseConv2D, Linear)):
                scales[layer.name] = _scale_of(prev)
            elif isinstance(layer, StackedBlocks):
                scales[layer.name] = _trunk_calibrate(layer, prev)
            elif isinstance(layer, ResidualBlock):
                scales[layer.name] = _block_calibrate(layer, prev)
            prev = acts[layer.name]
    return scales


def _pad_to(n: int) -> int:
    return -(-n // MM_ALIGN) * MM_ALIGN


def _mm_weights(w_q: torch.Tensor) -> torch.Tensor:
    """int8 weights [..., K', N] (HWIO, or [in, out]; a leading [L] axis
    for a trunk) as the product's right operand, transposed: [(L,) Np, Kp],
    contiguous, zero-padded to multiples of 8; ``_int_mm`` takes its
    transpose, a column-major [Kp, Np]."""
    stacked = w_q.dim() == 5
    lead = w_q.shape[:1] if stacked else ()
    n = w_q.shape[-1]
    mat = w_q.reshape(*lead, -1, n)
    k = mat.shape[-2]
    out = w_q.new_zeros((*lead, _pad_to(n), _pad_to(k)))
    out[..., :n, :k] = mat.transpose(-1, -2)
    return out


def _qentry(w: torch.Tensor, b: torch.Tensor, in_scale, axis: int,
            dense: bool) -> dict:
    q, s = _quantize_weight(w, axis)
    p = {"w_q": q, "w_scale": s, "b": b.detach(), "in_scale": in_scale}
    if dense:
        p["w_mm"] = _mm_weights(q)
    return p


def quantize_int8(model, calib_images_u8):
    """-> ``(folded_model, qparams)``: int8 weights and scales (and each
    dense product's padded operand, ``w_mm``) for every conv and the dense
    head, scanned-trunk convs per block; other layers keep their float32
    params in the folded model."""
    folded = fold_batchnorm(model)
    act = calibrate_activation_scales(folded, calib_images_u8)
    qparams = {}
    for layer in folded.net:
        if isinstance(layer, (Conv2D, DepthwiseConv2D)):
            qparams[layer.name] = _qentry(layer.w, layer.b, act[layer.name],
                                          3, isinstance(layer, Conv2D))
        elif isinstance(layer, Linear):
            qparams[layer.name] = _qentry(layer.w, layer.b, act[layer.name],
                                          1, True)
        elif isinstance(layer, ResidualBlock):
            scales = act[layer.name]
            blk = {"body": {l.name: _qentry(l.w, l.b, scales[l.name], 3, True)
                            for l in layer.body if isinstance(l, Conv2D)}}
            if layer.proj is not None:
                blk["proj"] = _qentry(layer.proj.w, layer.proj.b,
                                      scales[layer.proj.name], 3, True)
            qparams[layer.name] = blk
        elif isinstance(layer, StackedBlocks):
            trunk = {}
            for l in layer.block.body:
                if not isinstance(l, Conv2D):
                    continue
                q, s = _quantize_weight_stacked(
                    getattr(layer, f"body/{l.name}/w"))
                trunk[l.name] = {
                    "w_q": q, "w_scale": s,
                    "b": getattr(layer, f"body/{l.name}/b").detach(),
                    "in_scale": act[layer.name][l.name],
                    "w_mm": _mm_weights(q)}
            qparams[layer.name] = trunk
    return folded, qparams


def _q_act(x: torch.Tensor, in_scale: torch.Tensor) -> torch.Tensor:
    """round half to even, as ``jnp.round``; clipped to +-127."""
    return torch.clamp(torch.round(x / in_scale), -127, 127).to(torch.int8)


def _mm_s32(cols: torch.Tensor, w_mm: torch.Tensor, m: int,
            n: int) -> torch.Tensor:
    """cols [m + MM_ROWS_PAD, Kp] int8 (row-major) times ``w_mm``'s
    transpose -> the exact int32 [m, n]."""
    return torch._int_mm(cols, w_mm.t())[:m, :n]


def _conv_s32(qx: torch.Tensor, w_mm: torch.Tensor, k: int, stride: int,
              padding: int, n: int) -> torch.Tensor:
    """int8 NHWC conv as im2col x weights: [B,Ho,Wo,n] int32, exact. The
    columns' order is the weights' HWIO order, (dy, dx, ci)."""
    if padding:
        qx = torch.nn.functional.pad(qx, (0, 0, padding, padding, padding,
                                          padding))
    bsz, h, wid, c = qx.shape
    ho, wo = conv_out_size(h, k, stride), conv_out_size(wid, k, stride)
    m = bsz * ho * wo
    cols = qx.new_zeros((m + MM_ROWS_PAD, w_mm.shape[-1]))
    view = cols[:m, :k * k * c].view(bsz, ho, wo, k, k, c)
    for dy in range(k):
        for dx in range(k):
            view[:, :, :, dy, dx, :] = qx[:, dy:dy + stride * (ho - 1) + 1:
                                          stride, dx:dx + stride * (wo - 1)
                                          + 1:stride, :]
    return _mm_s32(cols, w_mm, m, n).reshape(bsz, ho, wo, n)


def _depthwise_s32(qx: torch.Tensor, w_q: torch.Tensor, stride: int,
                   padding: int) -> torch.Tensor:
    """int8 depthwise conv (``cnn_tpu``'s ``feature_group_count=C``): output
    channel ``g*mult + m`` reads input channel ``g``; [B,Ho,Wo,C*mult]
    int32. The k*k taps are summed as int32 products, exact by
    construction; no library conv runs, so no backend's choice of
    algorithm (a transform-based one, or TF32) can enter."""
    k, c_out = w_q.shape[0], w_q.shape[3]
    mult = c_out // qx.shape[-1]
    if padding:
        qx = torch.nn.functional.pad(qx, (0, 0, padding, padding, padding,
                                          padding))
    xi = qx.to(torch.int32)
    if mult > 1:
        xi = xi.repeat_interleave(mult, dim=-1)
    wi = w_q.to(torch.int32)
    h, wid = xi.shape[1], xi.shape[2]
    ho, wo = conv_out_size(h, k, stride), conv_out_size(wid, k, stride)
    acc = None
    for dy in range(k):
        for dx in range(k):
            tap = xi[:, dy:dy + stride * (ho - 1) + 1:stride,
                     dx:dx + stride * (wo - 1) + 1:stride, :] * wi[dy, dx, 0]
            acc = tap if acc is None else acc + tap
    return acc


def _q_conv(layer, p: dict, x: torch.Tensor) -> torch.Tensor:
    """int8 conv, dense or depthwise: s8 x s8 -> s32, then the float32
    dequant + bias epilogue."""
    qx = _q_act(x, p["in_scale"])
    if isinstance(layer, DepthwiseConv2D):
        acc = _depthwise_s32(qx, p["w_q"], layer.stride, layer.padding)
    else:
        acc = _conv_s32(qx, p["w_mm"], layer.kernel_size, layer.stride,
                        layer.padding, layer.out_channels)
    return acc.float() * (p["in_scale"] * p["w_scale"]) + p["b"]


def _q_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(x.shape[0], -1)       # ops/linear.py flattens NHWC
    qx = _q_act(x, p["in_scale"])
    m, k = qx.shape
    cols = qx.new_zeros((m + MM_ROWS_PAD, p["w_mm"].shape[-1]))
    cols[:m, :k] = qx
    acc = _mm_s32(cols, p["w_mm"], m, p["w_q"].shape[1])
    return acc.float() * (p["in_scale"] * p["w_scale"]) + p["b"]


def quantized_apply(folded: FoldedModel, qparams: dict,
                    x: torch.Tensor) -> torch.Tensor:
    """int8 forward of float32 images [B,H,W,3] in [0, 1] -> float32
    logits: every conv and the dense head s8 x s8 -> s32 with a float32
    dequant + bias epilogue; everything else float32. A stacked trunk runs
    block by block on slice i of its int8 weights and scales."""
    for layer in folded.net:
        p = qparams.get(layer.name)
        if isinstance(layer, (Conv2D, DepthwiseConv2D)):
            x = _q_conv(layer, p, x)
        elif isinstance(layer, ResidualBlock):
            h = x
            for l in layer.body:
                h = (_q_conv(l, p["body"][l.name], h)
                     if isinstance(l, Conv2D) else l(h))
            sc = (_q_conv(layer.proj, p["proj"], x)
                  if layer.proj is not None else x)
            x = ResidualBlock.combine(h, sc)
        elif isinstance(layer, StackedBlocks):
            body = list(layer.block.body)
            for i in range(layer.n_blocks):
                y = x
                for l in body:
                    y = (_q_conv(l, {k: v[i] for k, v in p[l.name].items()},
                                 y)
                         if isinstance(l, Conv2D) else l(y))
                x = ResidualBlock.combine(y, x)
        elif isinstance(layer, Linear):
            x = _q_linear(p, x)
        else:
            x = layer(x)
    return x


def make_int8_forward(model, calib_images_u8):
    """uint8 images [N,H,W,3] (a tensor on the model's device) -> softmax
    probabilities through the folded int8 graph."""
    folded, qparams = quantize_int8(model, calib_images_u8)

    @torch.no_grad()
    def forward(images_u8: torch.Tensor) -> torch.Tensor:
        logits = quantized_apply(folded, qparams, uint8_normalize(images_u8))
        return torch.softmax(logits.float(), dim=-1)

    return forward


class QuantizedModel(nn.Module):
    """A folded model and its int8 ``qparams`` as one module whose forward
    is ``quantized_apply`` (the serving engine's and the artifact's int8
    graph)."""

    def __init__(self, folded: FoldedModel, qparams: dict):
        super().__init__()
        self.folded = folded
        self.qparams = qparams
        self.image_size = folded.image_size
        self.num_classes = folded.num_classes

    def forward(self, x, compute_dtype=None):
        del compute_dtype           # the int8 graph has its own dtypes
        return quantized_apply(self.folded, self.qparams, x)

"""VALID conv + bias (+ ReLU), NHWC/HWIO float32: wrapper of ``csrc/conv.cu``.

Replaces the forward of ``cnn_tpu/ops/pallas/conv.py:conv2d_bias_relu_pallas``
(``_forward``). Its backward is for the training slice.
"""

from __future__ import annotations

import torch

from cnn_tpu_torch.ops.conv import conv2d, conv_out_size
from cnn_tpu_torch.ops.hopper._build import cuda_args, launch


def conv2d_bias_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     stride: int = 2, relu: bool = True) -> torch.Tensor:
    """x [B,H,W,Cin], w [k,k,Cin,Cout], b [Cout] -> [B,Ho,Wo,Cout].

    A CPU tensor takes the plain version (``ops/conv.py:conv2d``).
    """
    if x.dim() != 4 or w.dim() != 4 or b.dim() != 1:
        raise ValueError("conv2d_bias_relu: expects x [B,H,W,Cin], "
                         "w [k,k,Cin,Cout], b [Cout]")
    bsz, h, wid, cin = x.shape
    k, k2, wcin, cout = w.shape
    if k != k2 or wcin != cin or b.shape[0] != cout or stride < 1:
        raise ValueError(f"conv2d_bias_relu: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}, stride {stride}")
    if h < k or wid < k:
        raise ValueError(f"conv2d_bias_relu: extent {h}x{wid} is below k={k}")
    if x.device.type == "cpu":
        return conv2d(x, w, b, stride, relu)
    stream = cuda_args("conv2d_bias_relu", x, w, b, dtypes=(torch.float32,) * 3)
    out = torch.empty((bsz, conv_out_size(h, k, stride),
                       conv_out_size(wid, k, stride), cout),
                      dtype=torch.float32, device=x.device)
    launch("cnn_conv2d_bias_relu", x.device, stream, x.data_ptr(),
           w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, h, wid, cin, cout,
           k, stride, int(relu))
    conv2d_bias_relu.launches += 1
    return out


conv2d_bias_relu.launches = 0

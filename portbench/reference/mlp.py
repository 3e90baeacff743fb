"""Frozen copy of humor_torch/ops/mlp.py, part of the benchmark's plain
reference; it imports nothing of humor_torch.

MLP with GroupNorm(16)+ReLU, the building block of the three HuMoR
networks (port of humor_tpu/ops/mlp.py).

Params are a list of dicts {"w": (in, out), "b", and from layer 1 on
"gn_scale"/"gn_bias" over the previous layer's output}, the JAX layout,
so converted checkpoints drop in. With `skip_dim > 0` the last
`skip_dim` input features (HuMoR's latent z) are concatenated to the
input of every layer after the first.

`compute_dtype="bfloat16"` is the JAX package's precision policy: each
product takes bf16-rounded activations and weights, accumulates in f32
and returns f32; the bias, GroupNorm, ReLU and the skip concat stay f32.
On the card the product runs on bf16 tensor cores with an f32 output
(`torch.mm(..., out_dtype=torch.float32)`); on the CPU it is the f32
product of the rounded inputs, which is what JAX computes there.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

GN_GROUPS = 16
GN_EPS = 1e-5


def init_mlp(widths: Sequence[int], generator: torch.Generator,
             skip_dim: int = 0, device="cpu") -> List[dict]:
    """torch.nn.Linear-style init (uniform +-1/sqrt(fan_in))."""
    params: List[dict] = []
    prev = widths[0]
    for i, width in enumerate(widths[1:]):
        fan_in = prev if i == 0 else prev + skip_dim
        bound = 1.0 / fan_in ** 0.5
        w = (torch.rand(fan_in, width, generator=generator) * 2 - 1) * bound
        b = (torch.rand(width, generator=generator) * 2 - 1) * bound
        layer = {"w": w.to(device), "b": b.to(device)}
        if i > 0:
            layer["gn_scale"] = torch.ones(prev, device=device)
            layer["gn_bias"] = torch.zeros(prev, device=device)
        params.append(layer)
        prev = width
    return params


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int = GN_GROUPS, eps: float = GN_EPS) -> torch.Tensor:
    """GroupNorm over the last axis with per-feature affine."""
    *batch, C = x.shape
    g = x.reshape(*batch, groups, C // groups)
    mean = g.mean(dim=-1, keepdim=True)
    cent = g - mean
    var = (cent * cent).mean(dim=-1, keepdim=True)
    out = (cent * torch.rsqrt(var + eps)).reshape(*batch, C)
    return out * scale + bias


COMPUTE_DTYPES = {"bfloat16": torch.bfloat16}


def resolve_compute_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """The products' input type: None or "" -> None (f32 products),
    "bfloat16" -> torch.bfloat16; any other name raises."""
    if not name:
        return None
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {name!r}: humor_torch takes "
                         f"{tuple(COMPUTE_DTYPES)} or none")
    return COMPUTE_DTYPES[name]


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N), both low precision, accumulated and returned
    in f32: tensor cores on the card, the f32 product of the rounded
    values on the CPU."""
    if a.is_cuda:
        try:
            return torch.mm(a, b, out_dtype=torch.float32)
        except TypeError as e:
            raise RuntimeError(
                "this torch has no low-precision GEMM with an f32 output "
                "(torch.mm(..., out_dtype=)); the bf16 policy needs one")\
                from e
    return a.float() @ b.float()


class _LowPrecisionMatmul(torch.autograd.Function):
    """h (..., K) @ w (K, N) with both inputs rounded to `dtype` and the
    product in f32: JAX's `matmul(h.astype(dt), w.astype(dt),
    preferred_element_type=f32)`. Its backward is JAX's VJP of that
    expression: each input's cotangent is the f32 product of the output's
    cotangent with the other rounded input, rounded to `dtype` (the
    transposed product returns the rounded input's type) and cast back to
    f32 (the transpose of the cast)."""

    @staticmethod
    def forward(ctx, h, w, dtype):
        hc = h.reshape(-1, h.shape[-1]).to(dtype)
        wc = w.to(dtype)
        ctx.save_for_backward(hc, wc)
        ctx.h_dtype, ctx.w_dtype = h.dtype, w.dtype
        return _product_f32(hc, wc).reshape(*h.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        hc, wc = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float()
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = (g2 @ wc.float().t()).to(hc.dtype).to(ctx.h_dtype)
            dh = dh.reshape(*g.shape[:-1], hc.shape[-1])
        if ctx.needs_input_grad[1]:
            dw = (hc.float().t() @ g2).to(wc.dtype).to(ctx.w_dtype)
        return dh, dw, None


def mlp_apply(params: List[dict], x: torch.Tensor, skip_dim: int = 0,
              compute_dtype: Optional[str] = None) -> torch.Tensor:
    """x (..., d_in) -> (..., d_out). `compute_dtype` ("bfloat16" or None)
    rounds only the products' inputs (see the module docstring)."""
    cdt = resolve_compute_dtype(compute_dtype)
    skip = x[..., x.shape[-1] - skip_dim:] if skip_dim > 0 else None
    h = x
    for i, layer in enumerate(params):
        if i > 0:
            h = torch.relu(group_norm(h, layer["gn_scale"], layer["gn_bias"]))
            if skip is not None:
                h = torch.cat([h, skip], dim=-1)
        w, b = layer["w"], layer["b"]
        h = (h @ w if cdt is None
             else _LowPrecisionMatmul.apply(h, w, cdt)) + b
    return h

"""Mamba-1 selective SSM block of the port (the SSM branch of hymba).

Port of ``repro.models.ssm``, in plain PyTorch. The recurrence
h_t = Ā_t ⊙ h_{t-1} + B̄_t u_t (diagonal Ā) runs in chunks of ``chunk`` steps:
within a chunk a log-depth scan on whole tensors (Hillis–Steele doubling, 7
steps at chunk 128: step s combines each step's affine map with the one s
steps before it), across chunks a Python loop carrying the (B, C, N) float32
boundary state. The fused prefill scan builds a chunk's Ā = exp(dt·A) and
B̄u = dt·u·B, scans them and contracts with C at once, so no (B, T, C, N)
tensor exists. The association order is not jax's ``associative_scan``'s, so
the scan agrees with the reference to rounding, not bit for bit. No closed
form (a cumulative product and a division) is used: A reaches −N, and the
running products of exp(dt·A) underflow.

Decode is the O(1) recurrent update. The reference's dtypes are kept, also
where its decode's arithmetic is not its prefill's: the prefill forms dt·u in
float32 and sums the conv taps one bfloat16 product and add at a time, the
decode forms dt·u in the model dtype before the cast and sums the taps in one
product; y is cast to the model dtype before ``+ u·D`` in both; dt is a
softplus in the model dtype; ``A_log`` is float32 whatever the model's dtype,
also through ``Module.to`` (:meth:`Mamba._apply`).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models import layers
from repro_torch.utils import prng


class Mamba(nn.Module):
    """One Mamba block's weights, the reference's (in, out) orientation: in_proj
    (d, 2C), conv_w (K, C), conv_b (C,), x_proj (C, r + 2N), dt_proj_w (r, C),
    dt_proj_b (C,), A_log (C, N) float32, D (C,), out_proj (C, d)."""

    LEAVES = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj_w", "dt_proj_b", "A_log", "D", "out_proj")

    def __init__(self, **leaves: torch.Tensor):
        super().__init__()
        for name in self.LEAVES:
            setattr(self, name, layers._param(leaves[name]))

    def _apply(self, fn, recurse=True):
        """``Module.to(dtype)`` and the like move ``A_log`` but keep it float32."""
        a_log = self.A_log

        def keep_f32(t):
            out = fn(t)
            if t is a_log and out.dtype != torch.float32:
                out = t.to(device=out.device)
            return out

        return super()._apply(keep_f32, recurse)


def init_mamba(key: torch.Tensor, d: int, *, d_inner: int, state: int, d_conv: int, dt_rank: int,
               dtype: torch.dtype, device) -> Mamba:
    """The reference's ``init_mamba``: ``split(key, 6)``; in_proj, conv_w, x_proj,
    dt_proj_w and out_proj one normal draw each times 1/√d, 0.5, 1/√C, 1/√r and
    1/√C, rounded to ``dtype``; conv_b zeros, dt_proj_b softplus⁻¹(0.01), D
    ones; A_log = log(1…N) on every channel, float32 (jax's CPU log,
    ``prng.xla_log``)."""
    ks = prng.split(key, 6)
    s_d, s_i, s_r = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_inner), 1.0 / math.sqrt(dt_rank)
    A = torch.arange(1, state + 1, dtype=torch.float32, device=device).expand(d_inner, state)
    return Mamba(
        in_proj=layers.draw_normal(ks[0], (d, 2 * d_inner), s_d, dtype, device),
        conv_w=layers.draw_normal(ks[1], (d_conv, d_inner), 0.5, dtype, device),
        conv_b=torch.zeros((d_inner,), dtype=dtype, device=device),
        x_proj=layers.draw_normal(ks[2], (d_inner, dt_rank + 2 * state), s_i, dtype, device),
        dt_proj_w=layers.draw_normal(ks[3], (dt_rank, d_inner), s_r, dtype, device),
        dt_proj_b=torch.full((d_inner,), math.log(math.e**0.01 - 1), dtype=dtype, device=device),
        A_log=prng.xla_log(A).contiguous(),
        D=torch.ones((d_inner,), dtype=dtype, device=device),
        out_proj=layers.draw_normal(ks[4], (d_inner, d), s_i, dtype, device),
    )


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax's ``softplus``: ``logaddexp(x, 0)`` in x's dtype."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor, init_state=None) -> torch.Tensor:
    """Depthwise causal conv. u: (B, T, C); w: (K, C), tap i of the window pairs
    u[t − i] with w[i]; init_state: (B, K − 1, C), the steps before u[0]."""
    K, T = w.shape[0], u.shape[1]
    if init_state is None:
        u_pad = F.pad(u, (0, 0, K - 1, 0))
    else:
        u_pad = torch.cat([init_state.to(u.dtype), u], dim=1)
    out = torch.zeros_like(u)
    for i in range(K):
        out = out + u_pad[:, i : i + T] * w[K - 1 - i][None, None, :]
    return out + b[None, None, :]


def _scan_within(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis 1 of the maps h ↦ a_t·h + b_t: returns the
    composed (a, b) of steps 0…t at each t, by doubling (⌈log₂ T⌉ steps). Each
    step writes into the other of two buffer pairs; the inputs are not written.
    Where autograd records (training) or the tiles are DTensors, each step
    makes new tensors instead, of the same values."""
    T, s = a.shape[1], 1
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad) or is_dtensor(a):
        while s < T:
            a, b = (torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1),
                    torch.cat([b[:, :s], torch.addcmul(b[:, s:], a[:, s:], b[:, :-s])], dim=1))
            s *= 2
        return a, b
    out, spare = (torch.empty_like(a), torch.empty_like(b)), None
    while s < T:
        na, nb = out
        nb[:, :s] = b[:, :s]
        torch.addcmul(b[:, s:], a[:, s:], b[:, :-s], out=nb[:, s:])
        na[:, :s] = a[:, :s]
        torch.mul(a[:, s:], a[:, :-s], out=na[:, s:])
        spare = (torch.empty_like(a), torch.empty_like(b)) if spare is None else (a, b)
        (a, b), out = out, spare
        s *= 2
    return a, b



def _pad_steps(x: torch.Tensor, t_pad: int, value: float = 0.0) -> torch.Tensor:
    """(B, T, ...) padded with ``value`` to T = t_pad on axis 1."""
    T = x.shape[1]
    if t_pad == T:
        return x
    return F.pad(x, (0, 0) * (x.ndim - 2) + (0, t_pad - T), value=value)


def _ssm_scan_chunked(dA: torch.Tensor, dBu: torch.Tensor, h0: torch.Tensor,
                      chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = dA_t ⊙ h_{t−1} + dBu_t. dA, dBu: (B, T, C, N); h0: (B, C, N).
    Returns (hs (B, T, C, N), h_T): the unfused scan, the plain version the
    fused one is held against (tests only)."""
    T = dA.shape[1]
    t_pad = -(-T // chunk) * chunk
    dA, dBu = _pad_steps(dA, t_pad, 1.0), _pad_steps(dBu, t_pad)
    h, hs = h0, []
    for j in range(0, t_pad, chunk):
        a, bb = _scan_within(dA[:, j : j + chunk], dBu[:, j : j + chunk])
        hc = a * h[:, None] + bb
        hs.append(hc)
        h = hc[:, -1]
    return torch.cat(hs, dim=1)[:, :T], h


def _ssm_scan_fused(u: torch.Tensor, dt: torch.Tensor, Bmat: torch.Tensor, Cmat: torch.Tensor, A: torch.Tensor,
                    h0: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan fused with its inputs and its output: per chunk, dA =
    exp(dt·A) and dBu = (dt·u)·B in float32, the scan, the boundary state
    injected, and y = Σ_n h·C at once. u, dt: (B, T, C); Bmat, Cmat: (B, T, N);
    A: (C, N). T is padded to whole chunks with zeros (dt = 0: dA = 1, dBu =
    0, so h_T carries through the padding). Returns (y (B, T, C) float32, h_T)."""
    T = u.shape[1]
    t_pad = -(-T // chunk) * chunk
    u, dt, Bmat, Cmat = (_pad_steps(t, t_pad) for t in (u, dt, Bmat, Cmat))
    h, ys = h0, []
    for j in range(0, t_pad, chunk):
        sl = slice(j, j + chunk)
        dtf = dt[:, sl].to(torch.float32)
        dA = torch.exp(dtf[..., None] * A[None, None])
        dBu = (dtf * u[:, sl].to(torch.float32))[..., None] * Bmat[:, sl].to(torch.float32)[:, :, None, :]
        a, bb = _scan_within(dA, dBu)
        del dA, dBu
        hs = a * h[:, None] + bb
        del a, bb
        ys.append(torch.einsum("btcn,btn->btc", hs, Cmat[:, sl].to(torch.float32)))
        h = hs[:, -1]
    return torch.cat(ys, dim=1)[:, :T], h


def mamba_forward(p: Mamba, x: torch.Tensor, *, state: int, dt_rank: int, chunk: int = 128,
                  return_state: bool = False):
    """The whole-sequence block. x: (B, T, d) -> (B, T, d).

    ``return_state=True`` also returns (conv_tail, h_T): the last K − 1 pre-conv
    activations (left-padded with zeros when T < K − 1) and the final SSM
    state, the decode cache after a batched prefill."""
    T = x.shape[1]
    u_raw, z = torch.chunk(x @ p.in_proj, 2, dim=-1)
    u = F.silu(_causal_conv(u_raw, p.conv_w, p.conv_b))
    dt, Bmat, Cmat = torch.split(u @ p.x_proj, [dt_rank, state, state], dim=-1)
    dt = softplus(dt @ p.dt_proj_w + p.dt_proj_b)
    A = -torch.exp(p.A_log)
    h0 = torch.zeros((x.shape[0], u.shape[-1], state), dtype=torch.float32, device=x.device)
    y, hT = _ssm_scan_fused(u, dt, Bmat, Cmat, A, h0, chunk)
    y = y.to(x.dtype)
    y = y + u * p.D[None, None, :]
    y = y * F.silu(z)
    out = y @ p.out_proj
    if return_state:
        K = p.conv_w.shape[0]
        tail = u_raw[:, T - (K - 1) :] if T >= K - 1 else F.pad(u_raw, (0, 0, K - 1 - T, 0))
        return out, (tail, hT)
    return out


def mamba_decode(p: Mamba, x: torch.Tensor, conv_state: torch.Tensor, ssm_state: torch.Tensor, *, state: int,
                 dt_rank: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token recurrent update. x: (B, 1, d); conv_state: (B, K − 1, C), the
    pre-conv inputs before x; ssm_state: (B, C, N). Returns (out (B, 1, d), new
    conv_state, new ssm_state)."""
    u, z = torch.chunk(x @ p.in_proj, 2, dim=-1)  # (B, 1, C) each
    window = torch.cat([conv_state.to(u.dtype), u], dim=1)  # (B, K, C)
    new_conv = window[:, 1:].to(conv_state.dtype)
    # window[K − 1] is the current token; _causal_conv pairs u[t − j] with w[j],
    # so the taps run reversed against the window's time order.
    u1 = F.silu(torch.einsum("bkc,kc->bc", window, torch.flip(p.conv_w, [0])) + p.conv_b)
    dt, Bv, Cv = torch.split(u1 @ p.x_proj, [dt_rank, state, state], dim=-1)
    dt = softplus(dt @ p.dt_proj_w + p.dt_proj_b)
    A = -torch.exp(p.A_log)
    dA = torch.exp(dt.to(torch.float32)[..., None] * A[None])  # (B, C, N)
    dBu = (dt * u1).to(torch.float32)[..., None] * Bv.to(torch.float32)[:, None, :]
    new_ssm = dA * ssm_state + dBu
    y = torch.einsum("bcn,bn->bc", new_ssm, Cv.to(torch.float32)).to(x.dtype)
    y = y + u1 * p.D[None, :]
    y = (y * F.silu(z[:, 0]))[:, None, :]
    return y @ p.out_proj, new_conv, new_ssm.to(ssm_state.dtype)

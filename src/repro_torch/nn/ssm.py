"""Mamba-2 SSD block (port of ``repro.nn.ssm``): the chunked prefill and
training forward, and the constant-state decode step.

The chunked SSD algorithm (Dao & Gu 2024) splits the sequence into chunks
of Q tokens: inside a chunk the recurrence is a masked quadratic form,
across chunks a (B, H, N, P) state is carried by a scan.  The four
projections (``in_xbc``, ``in_z``, ``in_dt``, ``out``) run on K1 through
``nn.quantized``'s serve path (``serve=True``), or fake-quant under
autograd (``serve=False``, the QAT forward); the state, the scan and
every einsum stay in f32, as in the reference.  B and C are repeated over
each group's heads by a broadcast and a reshape, whose gradient is a sum
over the group (``repeat_interleave``'s is an index-add, whose atomics add
in no fixed order on a card).

The prompt is padded up to a multiple of ``chunk`` upstream, and the pad
tokens must not touch the state.  The reference lets them (ROADMAP Queue 3
R6): a pad's ``softplus(dt + dt_bias)`` is positive, so it decays the
state, its conv output carries the bias and the real tokens' tails into
the state, and the conv cache becomes the pad's zeros.  Here ``dt`` is 0 at
every position at or past ``valid`` (decay 1, input 0), and the conv cache
is the last ``conv_width - 1`` real pre-conv rows, zero-filled on the left
for a prompt shorter than that.  Real positions' outputs are unchanged:
the conv is causal and the quadratic form sums over earlier positions
only.

On a card the einsums run one batch row at a time and the decode step's
products as elementwise products plus one sum over the last axis, so a
row's bits do not depend on the batch it is served in (cuBLAS and torch's
reductions pick their kernels by the shape); on the CPU the batched forms
already compute each row alone.

Tensor-parallel serving (``mesh=`` with a 'model' axis of M above 1): a
rank holds the heads ``[r H/M, (r + 1) H/M)``: its x columns of
``in_xbc`` and of the conv with B and C whole (``xbc_pieces``; every head
reads B and C), its columns of ``in_z``, ``in_dt``, ``A_log``, ``D`` and
``dt_bias``, the norm whole and its rows of ``out``, and its heads' part
of the state (``ssm_state_spec(model=M)``).  The chunk math and the
decode step's contraction run at the one-device head count, the rank's
heads at their own index and the rest zeros, so each head's bits are the
one-device head's (the kernels, and their sums' order, are picked by the
shape).  The gated norm spans all of ``d_inner``: the gated rows are
all-gathered over 'model', normed whole, and the rank's block goes into
``out`` as a row shard (K1 accumulator-only, int32 sums); the fp baseline
multiplies its whole ``out`` by the whole row instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import mesh as mesh_lib
from repro_torch.nn import layers
from repro_torch.nn import quantized as Q
from repro_torch.nn.param import ParamSpec

__all__ = ["SSMConfig", "ssm_spec", "ssd_forward", "ssd_decode_step",
           "ssm_state_spec", "xbc_pieces"]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def ssm_spec(cfg: SSMConfig, *, serve: bool = False, policy=None) -> Dict:
    """The block's parameters; the projections' spec names double as the
    plan-layer names (mamba2's ``gemm_workload`` names)."""
    if serve:
        mk = lambda i, o, nm, ax: Q.qlinear_serve_spec(  # noqa: E731
            i, o, axes=ax, policy=policy, name=nm)
    else:
        mk = lambda i, o, nm, ax: Q.qlinear_spec(  # noqa: E731
            i, o, axes=ax, name=nm)
    d, di = cfg.d_model, cfg.d_inner
    gn = cfg.n_groups * cfg.d_state
    h = cfg.n_heads
    return {
        "in_xbc": mk(d, di + 2 * gn, "in_xbc", ("embed", "mlp")),
        "in_z": mk(d, di, "in_z", ("embed", "mlp")),
        "in_dt": mk(d, h, "in_dt", ("embed", "heads")),
        "out": mk(di, d, "out", ("mlp", "act_embed")),
        "conv": layers.conv1d_spec(cfg.conv_channels, cfg.conv_width),
        "A_log": ParamSpec(shape=(h,), axes=("heads",), init="constant",
                           const=0.0),
        "D": ParamSpec(shape=(h,), axes=("heads",), init="ones"),
        "dt_bias": ParamSpec(shape=(h,), axes=("heads",), init="zeros"),
        "norm": layers.rmsnorm_spec(di),
    }


def ssm_state_spec(cfg: SSMConfig, batch: int,
                   model: int = 1) -> Dict[str, ParamSpec]:
    """The decode state; ``model`` > 1: one tensor-parallel rank's, its
    H/M heads and its conv channels (``xbc_pieces``)."""
    gn = cfg.n_groups * cfg.d_state
    return {
        "ssm": ParamSpec(shape=(batch, cfg.n_heads // model, cfg.d_state,
                                cfg.head_dim),
                         axes=("batch", "heads", "state", None),
                         init="zeros"),
        "conv": ParamSpec(shape=(batch, cfg.conv_width - 1,
                                 cfg.d_inner // model + 2 * gn),
                          axes=("batch", None, "mlp"), init="zeros"),
    }


def xbc_pieces(cfg: SSMConfig, r: int, m: int):
    """The ``in_xbc`` columns (and conv channels) rank ``r`` of ``m`` holds,
    as ``((start, stop), ...)``: the x columns of its heads, then B and C
    whole."""
    di = cfg.d_inner
    return ((r * di // m, (r + 1) * di // m),
            (di, di + 2 * cfg.n_groups * cfg.d_state))


def _proj(p, x, policy, impl, name, serve=True):
    return Q.qlinear_any(p, x, policy, serve=serve, impl=impl, name=name)


def _repeat_heads(t: torch.Tensor, reps: int) -> torch.Tensor:
    """(..., G, N) -> (..., G * reps, N), each group repeated over its
    ``reps`` heads (``jnp.repeat`` along the group axis)."""
    if reps == 1:
        return t
    *lead, g, n = t.shape
    return t[..., :, None, :].expand(*lead, g, reps, n).reshape(
        *lead, g * reps, n)


def _split_xbc(xbc, cfg: SSMConfig):
    """x, B and C of the (local) fused columns: x is all but the last
    2 G N."""
    gn = cfg.n_groups * cfg.d_state
    di = xbc.shape[-1] - 2 * gn
    return xbc[..., :di], xbc[..., di:di + gn], xbc[..., di + gn:]


def _pad_heads(t: torch.Tensor, axis: int, r: int, m: int) -> torch.Tensor:
    """A rank's heads (``axis``) at their own index among the one-device
    count, zeros elsewhere; ``t`` itself on one device."""
    if m == 1:
        return t
    h = t.shape[axis]
    pad = [0, 0] * (t.ndim - 1 - axis % t.ndim) + [r * h, (m - 1 - r) * h]
    return F.pad(t, pad)


def _own_heads(t: torch.Tensor, axis: int, r: int, m: int) -> torch.Tensor:
    """The rank's heads of a one-device-sized ``axis``."""
    if m == 1:
        return t
    h = t.shape[axis] // m
    return t.narrow(axis, r * h, h)


def _gated_out(p, y, z, policy, impl, serve, mesh):
    """The gated norm over all of ``d_inner``, then ``out``: y, z (..., di
    / M) -> (..., D).  On a tensor-parallel mesh the gated rows are
    all-gathered and normed whole; the rank's block runs ``out`` as a row
    shard, or the fp baseline's whole ``out`` takes the whole row."""
    g = y * F.silu(z.to(torch.float32)).to(y.dtype)
    r, m = mesh_lib.model_coords(mesh)
    if m == 1:
        return _proj(p["out"], layers.rmsnorm_apply(p["norm"], g), policy,
                     impl, "out", serve)
    whole = layers.rmsnorm_apply(
        p["norm"], mesh_lib.all_gather_model(mesh, g, dim=-1))
    if "w" in p["out"]:
        return _proj(p["out"], whole, policy, impl, "out")
    di = g.shape[-1]
    return Q.qlinear_serve_apply(p["out"], whole[..., r * di:(r + 1) * di],
                                 policy, impl=impl, name="out",
                                 row_mesh=mesh)


def _heads(cfg: SSMConfig, mesh, serve: bool):
    """(this rank's 'model' coordinate, the axis' size), checked: tensor
    parallelism serves only, over whole heads."""
    r, m = mesh_lib.model_coords(mesh)
    if m > 1 and (not serve or cfg.n_heads % m):
        raise ValueError(f"a tensor-parallel SSD block serves (serve=True) "
                         f"{cfg.n_heads} heads split evenly over {m} ranks")
    return r, m


def _ssd_chunks(xh, bm, cm, dtp, a, q: int):
    """The chunked SSD of rows (B, S, ...): xh (B, S, H, P), bm/cm (B, S,
    H, N), dtp (B, S, H), all f32, a (H,) -> (y (B, S, H, P) without the D
    skip, the final state (B, H, N, P))."""
    b, s, h, pdim = xh.shape
    n = bm.shape[-1]
    nc = s // q
    xc = xh.reshape(b, nc, q, h, pdim)
    bc = bm.reshape(b, nc, q, h, n)
    cc = cm.reshape(b, nc, q, h, n)
    dtc = dtp.reshape(b, nc, q, h)
    cum = torch.cumsum((dtp * a).reshape(b, nc, q, h), dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Qi, Qj, H)
    ii = torch.arange(q, device=xh.device)
    lmask = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # exp only below the diagonal: above it seg is a sum of positive
    # decays that overflows f32 at a full chunk, and where's backward
    # multiplies that inf by its zero gradient (the reference's NaN, R8)
    zero = torch.zeros_like(seg)
    ldecay = torch.where(lmask, torch.exp(torch.where(lmask, seg, zero)),
                         zero)
    cb = torch.einsum("bcihn,bcjhn->bcijh", cc, bc)
    y_diag = torch.einsum("bcijh,bcjh,bcjhp->bcihp", cb * ldecay, dtc, xc)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bcjh,bcjh,bcjhn,bcjhp->bchnp", decay_to_end, dtc,
                          bc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, H)
    carry = torch.zeros((b, h, n, pdim), dtype=torch.float32,
                        device=xh.device)
    prev = []
    for c in range(nc):  # emit the state entering chunk c
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, N, P)
    y_off = torch.einsum("bcihn,bchnp,bcih->bcihp", cc, prev_states,
                         torch.exp(cum))
    return (y_diag + y_off).reshape(b, s, h, pdim), carry


def ssd_forward(p: Dict, x_in: torch.Tensor, policy, cfg: SSMConfig, *,
                impl: str = "auto", valid: Optional[int] = None,
                serve: bool = True, mesh=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x_in (B, S, D), S a multiple of ``cfg.chunk`` -> (out (B, S, D), the
    recurrent state after the first ``valid`` positions (all of S by
    default): ``{"ssm": (B, H, N, P), "conv": (B, W-1, C)}``, f32).
    Positions at or past ``valid`` are padding and leave the state alone.
    ``serve=False`` runs the projections fake-quant (the QAT forward).
    ``mesh``: tensor-parallel over this rank's heads (module doc); the
    state is the rank's."""
    b, s, _ = x_in.shape
    h, pdim, n, g = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    r, m = _heads(cfg, mesh, serve)
    h_l = h // m
    if s % cfg.chunk:
        raise ValueError(f"S={s} is not a multiple of chunk {cfg.chunk}")
    valid = s if valid is None else valid
    xbc = _proj(p["in_xbc"], x_in, policy, impl, "in_xbc", serve)
    z = _proj(p["in_z"], x_in, policy, impl, "in_z", serve)
    dt = _proj(p["in_dt"], x_in, policy, impl, "in_dt", serve)
    pre_conv = F.silu(xbc.to(torch.float32)).to(xbc.dtype)
    xbc = layers.causal_conv1d(p["conv"], pre_conv)
    xr, bmat, cmat = _split_xbc(xbc, cfg)
    xh = xr.reshape(b, s, h_l, pdim).to(torch.float32)
    # B and C of every head: the chunk math runs at the one-device count
    bm = _repeat_heads(bmat.reshape(b, s, g, n).to(torch.float32), h // g)
    cm = _repeat_heads(cmat.reshape(b, s, g, n).to(torch.float32), h // g)
    a = -torch.exp(p["A_log"].to(torch.float32))
    dtp = layers.softplus(dt.to(torch.float32)
                          + p["dt_bias"].to(torch.float32))
    if valid < s:  # the pad tokens: decay 1, input 0
        dtp = torch.cat([dtp[:, :valid], torch.zeros_like(dtp[:, valid:])],
                        dim=1)
    xw, dw, aw = (_pad_heads(xh, 2, r, m), _pad_heads(dtp, 2, r, m),
                  _pad_heads(a, 0, r, m))
    if x_in.is_cuda:  # one row at a time: the same bits in any batch
        parts = [_ssd_chunks(xw[i:i + 1], bm[i:i + 1], cm[i:i + 1],
                             dw[i:i + 1], aw, cfg.chunk) for i in range(b)]
        y = torch.cat([pt[0] for pt in parts])
        final = torch.cat([pt[1] for pt in parts])
    else:
        y, final = _ssd_chunks(xw, bm, cm, dw, aw, cfg.chunk)
    y, final = _own_heads(y, 2, r, m), _own_heads(final, 1, r, m)
    y = y + p["D"].to(torch.float32)[None, None, :, None] * xh
    y = y.reshape(b, s, h_l * pdim).to(x_in.dtype)
    out = _gated_out(p, y, z, policy, impl, serve, mesh)
    w1 = cfg.conv_width - 1
    tail = pre_conv[:, max(0, valid - w1):valid, :].to(torch.float32)
    if tail.shape[1] < w1:
        tail = F.pad(tail, (0, 0, w1 - tail.shape[1], 0))
    return out, {"ssm": final, "conv": tail}


def _contract_n(cv: torch.Tensor, s_new: torch.Tensor, r: int = 0,
                m: int = 1) -> torch.Tensor:
    """einsum('bhn,bhnp->bhp') in f32.  On a card: the elementwise product
    into a buffer laid out with N last, then one sum over that axis (the
    decode attention's fixed-order form); on the CPU the einsum.  A
    tensor-parallel rank (``r`` of ``m``) runs it at the one-device head
    count, its heads at their own index."""
    if m > 1:
        return _own_heads(_contract_n(_pad_heads(cv, 1, r, m),
                                      _pad_heads(s_new, 1, r, m)), 1, r, m)
    if not cv.is_cuda:
        return torch.einsum("bhn,bhnp->bhp", cv, s_new)
    a, bb = cv[:, :, None, :], s_new.transpose(-1, -2)
    buf = torch.empty(torch.broadcast_shapes(a.shape, bb.shape),
                      dtype=torch.float32, device=cv.device)
    return torch.mul(a, bb, out=buf).sum(-1)


def ssd_decode_step(p: Dict, x_t: torch.Tensor, state: Dict[str, torch.Tensor],
                    policy, cfg: SSMConfig, *, impl: str = "auto",
                    serve: bool = True, mesh=None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrence: x_t (B, 1, D), ``state`` from
    ``ssm_state_spec`` -> (out (B, 1, D), the new state); ``serve=False``
    runs the projections fake-quant; ``mesh`` as ``ssd_forward``'s, the
    state the rank's (``ssm_state_spec(model=M)``)."""
    b = x_t.shape[0]
    h, pdim, n, g = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    r, m = _heads(cfg, mesh, serve)
    h_l = h // m
    xbc = _proj(p["in_xbc"], x_t, policy, impl, "in_xbc", serve)[:, 0]
    z = _proj(p["in_z"], x_t, policy, impl, "in_z", serve)[:, 0]
    dt = _proj(p["in_dt"], x_t, policy, impl, "in_dt", serve)[:, 0]
    conv_cache, xbc = layers.causal_conv1d_step(
        p["conv"], state["conv"].to(xbc.dtype),
        F.silu(xbc.to(torch.float32)).to(xbc.dtype))
    xr, bvec, cvec = _split_xbc(xbc, cfg)
    xh = xr.reshape(b, h_l, pdim).to(torch.float32)
    bv = _own_heads(_repeat_heads(bvec.reshape(b, g, n).to(torch.float32),
                                  h // g), 1, r, m)
    cv = _own_heads(_repeat_heads(cvec.reshape(b, g, n).to(torch.float32),
                                  h // g), 1, r, m)
    a = -torch.exp(p["A_log"].to(torch.float32))
    dtp = layers.softplus(dt.to(torch.float32)
                          + p["dt_bias"].to(torch.float32))
    decay = torch.exp(dtp * a)  # (B, H)
    # einsum('bh,bhn,bhp->bhnp') is an outer product: (dt * B) then * x
    s_new = (state["ssm"] * decay[:, :, None, None]
             + (dtp[:, :, None] * bv)[:, :, :, None] * xh[:, :, None, :])
    y = _contract_n(cv, s_new, r, m)
    y = y + p["D"].to(torch.float32)[None, :, None] * xh
    y = y.reshape(b, 1, h_l * pdim).to(x_t.dtype)
    out = _gated_out(p, y, z[:, None, :], policy, impl, serve, mesh)
    return out, {"ssm": s_new, "conv": conv_cache.to(torch.float32)}

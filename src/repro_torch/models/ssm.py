"""Mamba-2 SSD (state-space duality) layer, arXiv:2405.21060 (the port of
``repro/models/ssm.py``).

Scalar-identity A per head. The chunked SSD algorithm:
  * intra-chunk (quadratic in the chunk): Y_intra = (L ∘ (C Bᵀ)) X with
    L[s,r] = exp(a_s - a_r) 1[r<=s], a = cumsum(A·dt);
  * inter-chunk: a loop over chunks carries the [H, P, N] state.
Decode is the O(1) recurrence h' = exp(A dt) h + dt·B⊗x, y = C·h' + D x.

A depthwise causal conv (width 4) precedes the SSM on (x, B, C); its
rolling state is part of the decode cache. Cache tensors are updated in
place (see models/blocks.py).

The chunked scan here is plain PyTorch, as the JAX package's model path is
jnp; the ssd_chunk kernel is reached through
``kernels/ops.ssd_chunked_pallas``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.sharding.rules import batch_rows, hold_grad


def ssm_dims(cfg):
    d_inner = cfg.d_inner
    return d_inner, cfg.ssm_heads, d_inner + 2 * cfg.ssm_state


def ssm_params(gen, cfg, *, stacked: int = 0, device=None) -> dict:
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    d = cfg.d_model
    d_inner, heads, conv_dim = ssm_dims(cfg)
    n = cfg.ssm_state
    lead = (stacked,) if stacked else ()
    in_dim = 2 * d_inner + 2 * n + heads     # z, x, B, C, dt
    # A in (-inf, 0): A = -exp(a_log), a_log = log U[1, 16] on a grid
    a_init = torch.log(torch.linspace(1.0, 16.0, heads, dtype=torch.float32,
                                      device=device))
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, d, (*lead, d, in_dim), device, dtype),
        "conv_w": dense_init(gen, cfg.ssm_conv_width,
                             (*lead, cfg.ssm_conv_width, conv_dim), device,
                             dtype),
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dtype, device=device),
        "a_log": a_init.expand(*lead, heads).clone(),
        "d_skip": torch.ones((*lead, heads), **f32),
        "dt_bias": torch.zeros((*lead, heads), **f32),
        "norm_scale": torch.zeros((*lead, d_inner), **f32),
        "out_proj": dense_init(gen, d_inner, (*lead, d_inner, d), device,
                               dtype),
    }


def _split_proj(zxbcdt, cfg):
    d_inner, heads, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    return torch.split(zxbcdt, [d_inner, d_inner, n, n, heads], dim=-1)


def _causal_conv(u, w, bias, state=None):
    """Depthwise causal conv. u [B,S,Cd], w [W,Cd]. Returns (silu(out),
    new_state), the state being the last W-1 inputs (for decode)."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((u.shape[0], width - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = state.to(u.dtype)
    up = torch.cat([pad, u], dim=1)
    s = u.shape[1]
    out = up[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + up[:, i:i + s] * w[i]
    out = out + bias
    new_state = up[:, -(width - 1):] if width > 1 else pad
    return F.silu(out.float()).to(u.dtype), new_state


def ssd_chunked(x, b, c, dt, a_log, d_skip, cfg, *, initial_state=None):
    """Chunked SSD scan. x [B,S,H,P], b/c [B,S,N], dt [B,S,H]
    (post-softplus), a_log [H]. Returns (y [B,S,H,P], state [B,H,P,N])."""
    bsz, s_orig, h, p = x.shape
    n = b.shape[-1]
    q = min(cfg.ssm_chunk, s_orig)
    if s_orig % q:                           # dt = 0 steps: identity
        pad = q - s_orig % q

        def zpad(a):
            return F.pad(a, [0, 0] * (a.ndim - 2) + [0, pad])
        x, b, c, dt = zpad(x), zpad(b), zpad(c), zpad(dt)
    s = x.shape[1]
    a = -torch.exp(a_log.float())            # [H], negative
    ldec = dt.float() * a                    # [B,S,H]
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for c0 in range(0, s, q):
        sl = slice(c0, c0 + q)
        xc, bc, cc = x[:, sl].float(), b[:, sl].float(), c[:, sl].float()
        dtc = dt[:, sl].float()
        acum = torch.cumsum(ldec[:, sl], dim=1)            # [B,q,H]
        # L[s,r] = exp(acum_s - acum_r), r <= s; masked BEFORE the exp
        diff = acum[:, :, None, :] - acum[:, None, :, :]   # [B,q,q,H]
        l_mat = torch.exp(torch.where(tril[None, :, :, None], diff, -1e30))
        cb = torch.einsum("bsn,brn->bsr", cc, bc)          # [B,q,q]
        scores = cb[..., None] * l_mat
        xdt = xc * dtc[..., None]                          # [B,q,H,P]
        y_intra = torch.einsum("bsrh,brhp->bshp", scores, xdt)
        y_inter = torch.einsum("bsn,bhpn,bsh->bshp", cc, state,
                               torch.exp(acum))
        atot = acum[:, -1]                                 # [B,H]
        decay_r = torch.exp(atot[:, None] - acum)          # [B,q,H]
        dstate = torch.einsum("brn,brhp,brh->bhpn", bc, xdt, decay_r)
        state = state * torch.exp(atot)[:, :, None, None] + dstate
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    y = y + x.float() * d_skip[None, None, :, None]
    return y[:, :s_orig].to(x.dtype), state


def _ssd_local(x, b, c, dt, a_log, d_skip, cfg, *, initial_state=None):
    """ssd_chunked on each rank's batch rows under ``local_map``, every
    head whole (the scan's cumsum backward is a flip, which DTensor has
    no strategy for in every torch release the port runs on). a_log's and
    d_skip's gradients are partial sums over the batch axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    rows = batch_rows(x)
    whole = [Replicate()] * mesh.ndim
    part = [Partial() if p == Shard(0) else p for p in rows]
    ins = [t.redistribute(mesh, rows) for t in (x, b, c, dt)]
    ins += [t.redistribute(mesh, whole) for t in (a_log, d_skip)]
    pl, grads = [rows] * 4 + [whole] * 2, [rows] * 4 + [part] * 2
    if initial_state is not None:
        ins.append(initial_state.redistribute(mesh, rows))
        pl, grads = pl + [rows], grads + [rows]

    def scan(xx, bb, cc, dd, al, ds, st=None):
        return ssd_chunked(xx, bb, cc, dd, al, ds, cfg, initial_state=st)

    return local_map(scan, out_placements=(rows, rows),
                     in_placements=tuple(pl),
                     in_grad_placements=tuple(grads),
                     device_mesh=mesh)(*ins)


def ssd_step(x, b, c, dt, a_log, d_skip, state):
    """One decode step. x [B,H,P], b/c [B,N], dt [B,H], state [B,H,P,N]."""
    a = -torch.exp(a_log.float())
    decay = torch.exp(dt.float() * a)                      # [B,H]
    upd = torch.einsum("bn,bhp->bhpn", b.float(),
                       x.float() * dt[..., None])
    state_new = state * decay[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", c.float(), state_new)
    y = y + x.float() * d_skip[None, :, None]
    return y.to(x.dtype), state_new


def ssm_block(x, p, cfg, *, cache=None):
    """The mamba2 mixer. x [B,S,D]. cache: {"ssm" [B,H,P,N], "conv"
    [B,W-1,Cd]}. Decode (S == 1 with a cache) steps the recurrence from the
    cache; prefill with a cache starts the scan from cache["ssm"] (the conv
    from zeros, as in the JAX package) and writes both back in place.
    Returns (y [B,S,D], cache)."""
    bsz, s, _ = x.shape
    d_inner, heads, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    proj = x @ p["in_proj"]
    z, xi, b, c, dt = _split_proj(proj, cfg)
    conv_in = torch.cat([xi, b, c], dim=-1)
    decode = cache is not None and s == 1
    conv_out, conv_state = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                        cache["conv"] if decode else None)
    xi, b, c = torch.split(conv_out, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])
    xh = xi.reshape(bsz, s, heads, cfg.ssm_head_dim)
    if not decode:
        scan = _ssd_local if isinstance(xh, DTensor) else ssd_chunked
        y, final = scan(xh, b, c, dt, p["a_log"], p["d_skip"], cfg,
                        initial_state=None if cache is None
                        else cache["ssm"])
    else:
        y1, final = ssd_step(xh[:, 0], b[:, 0], c[:, 0], dt[:, 0],
                             p["a_log"], p["d_skip"], cache["ssm"])
        y = y1[:, None]
    if cache is not None:
        cache["ssm"].copy_(final)
        cache["conv"].copy_(conv_state.to(cache["conv"].dtype))
    # on a mesh the gradient arriving here is split along d_inner, which
    # the heads' reshape cannot take back where the heads do not divide
    # the model axis (mamba2's 24 on 16): hold it at y's placements
    y = hold_grad(y.reshape(bsz, s, d_inner))
    # gated RMS norm (mamba2): norm(y * silu(z))
    y = y * F.silu(z.float()).to(y.dtype)
    y = rms_norm(y, p["norm_scale"], cfg.norm_eps)
    return y @ p["out_proj"], cache


def init_ssm_cache(cfg, batch: int, dtype, device=None) -> dict:
    device = resolve_device(device)
    _, heads, conv_dim = ssm_dims(cfg)
    return {
        "ssm": torch.zeros((batch, heads, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }

"""Plain PyTorch version of the chunked SSD scan kernel.

It has the structure of the JAX package's ``ssd_chunk_scan_ref``
(``models/ssm.py``) — chunk padding, the within-chunk cumulative decay,
the masked intra-chunk matrix, the chunk-to-chunk state — and the
arithmetic of the TPU kernel it stands beside (``ssd_scan_kernel``):
every product in float32 (float64 for float64 inputs), the output
rounded to the input type once.  The JAX reference instead rounds C B^T
and the masked matrix to the input type before the intra-chunk product;
on mamba2-2.7b's bfloat16 activations that rounding alone moves y by up
to 1.3 times the bfloat16 tolerance (2e-2) from a float64 evaluation,
where the float32 products stay within a fifth of it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssd_chunk_scan_ref", "ssd_chunk_scan_bwd_ref", "chunk_len"]


def chunk_len(s: int, chunk: int) -> int:
    """The chunk the scan uses for S steps: ``chunk``, or S when S is
    not a multiple of it and shorter."""
    return min(chunk, s) if s % chunk else chunk


def ssd_chunk_scan_ref(xbar, a_log, Bm, Cm, h0=None, chunk: int = 128):
    """xbar (B,S,H,P) dt-scaled inputs; a_log (B,S,H) per-step log decay;
    Bm, Cm (B,S,N) shared across heads; h0 optional (B,H,N,P).  Returns
    (y (B,S,H,P) in xbar's type, h_final (B,H,N,P) float32, or float64
    for float64 inputs)."""
    b, s, h, p_ = xbar.shape
    n = Bm.shape[-1]
    f = torch.promote_types(xbar.dtype, torch.float32)
    q = chunk_len(s, chunk)
    if s % q:
        # a_log = 0 (decay 1) and xbar = 0 keep the final state exact;
        # the padded outputs are sliced off below
        pad = q - s % q
        xbar = F.pad(xbar, (0, 0, 0, 0, 0, pad))
        a_log = F.pad(a_log, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    s_pad = xbar.shape[1]
    nc = s_pad // q
    xb = xbar.reshape(b, nc, q, h, p_).to(f)
    al = a_log.reshape(b, nc, q, h).to(f)
    bm = Bm.reshape(b, nc, q, n).to(f)
    cm = Cm.reshape(b, nc, q, n).to(f)

    l = torch.cumsum(al, dim=2)                                 # (B,NC,Q,H)
    cb = torch.einsum("bcqn,bckn->bcqk", cm, bm)                # (B,NC,Q,Q)
    seg = l[:, :, :, None, :] - l[:, :, None, :, :]             # (B,NC,Q,Q,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xb.device))
    # mask before exp: above the diagonal seg is large and positive
    seg = torch.where(tri[None, None, :, :, None], seg,
                      torch.tensor(-1e30, dtype=f, device=seg.device))
    att = cb[..., None] * torch.exp(seg)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", att, xb)

    lq = l[:, :, -1, :]                                         # (B,NC,H)
    binp = torch.einsum("bcqn,bcqhp->bcnhp", bm,
                        torch.exp(lq[:, :, None, :] - l)[..., None] * xb)

    hstate = (torch.zeros((b, n, h, p_), dtype=f, device=xb.device)
              if h0 is None else h0.to(f).transpose(1, 2))      # (B,N,H,P)
    hprevs = []
    for c in range(nc):
        hprevs.append(hstate)
        hstate = hstate * torch.exp(lq[:, c])[:, None, :, None] + binp[:, c]
    hprev = torch.stack(hprevs, dim=1)                          # (B,NC,N,H,P)

    y_inter = torch.einsum("bcqn,bcnhp->bcqhp", cm,
                           hprev) * torch.exp(l)[..., None]
    y = (y_intra + y_inter).to(xbar.dtype)
    y = y.reshape(b, s_pad, h, p_)[:, :s]
    return y, hstate.transpose(1, 2).contiguous()               # (B,H,N,P)


def ssd_chunk_scan_bwd_ref(xbar, a_log, Bm, Cm, dy, dh, chunk: int = 128):
    """The gradients of :func:`ssd_chunk_scan_ref` (no ``h0``) for the
    output gradients ``dy`` (B,S,H,P) and ``dh`` (B,H,N,P), by the
    explicit formulas the backward kernel (``csrc/ssd_scan_bwd.cu``)
    computes, every product in float32 (float64 for float64 inputs).

    Per batch row, head and chunk, with l the within-chunk cumsum of
    a_log, L_ij = exp(l_i - l_j) for j <= i (0 above), M = (C B^T) o L,
    w_j = exp(l_Q - l_j), H_prev the chunk's incoming state and dH the
    gradient of its outgoing one (dh at the last chunk):

      dX      = M^T dY + diag(w) B dH
      dM      = (dY X^T) o tril,  dCB = dM o L,  G = dM o M
      dC      = sum_h [dCB B + diag(e^l) dY H_prev^T]
      dB      = sum_h [dCB^T C + diag(w) X dH^T]
      dH_prev = e^{l_Q} dH + C^T diag(e^l) dY
      dl_i    = sum_j G_ij - sum_k G_ki + <dY_i, e^{l_i} C_i H_prev> - r_i
                with r_j = w_j <B_j, dH X_j>, and at the last step
                dl_Q += e^{l_Q} <H_prev, dH> + sum_j r_j
      da_log  = the reverse cumsum of dl within the chunk.

    Returns (dxbar in xbar's type, da_log float32 (float64), dBm and dCm
    in Bm's type)."""
    b, s, h, p_ = xbar.shape
    n = Bm.shape[-1]
    f = torch.promote_types(xbar.dtype, torch.float32)
    q = chunk_len(s, chunk)
    if s % q:
        # the forward's padding (a_log = 0, x = 0); dy = 0 on the padded
        # steps, whose gradients are sliced off below
        pad = q - s % q
        xbar, dy = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xbar, dy))
        a_log = F.pad(a_log, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = xbar.shape[1] // q
    xb = xbar.reshape(b, nc, q, h, p_).to(f)
    gy = dy.reshape(b, nc, q, h, p_).to(f)
    al = a_log.reshape(b, nc, q, h).to(f)
    bm = Bm.reshape(b, nc, q, n).to(f)
    cm = Cm.reshape(b, nc, q, n).to(f)

    l = torch.cumsum(al, dim=2)                                 # (B,NC,Q,H)
    lq = l[:, :, -1, :]                                         # (B,NC,H)
    el = torch.exp(l)
    w = torch.exp(lq[:, :, None, :] - l)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xb.device))
    seg = torch.where(tri[None, None, :, :, None],
                      l[:, :, :, None, :] - l[:, :, None, :, :],
                      torch.tensor(-1e30, dtype=f, device=xb.device))
    big_l = torch.exp(seg)                                      # (B,NC,Q,Q,H)
    m = torch.einsum("bcin,bcjn->bcij", cm, bm)[..., None] * big_l

    # the states: H_prev by a forward walk, dH by a reverse one
    binp = torch.einsum("bcjn,bcjhp->bchnp", bm, w[..., None] * xb)
    dinp = torch.einsum("bcin,bcihp->bchnp", cm, el[..., None] * gy)
    decay = torch.exp(lq)[..., None, None]                      # (B,NC,H,1,1)
    hstate = torch.zeros((b, h, n, p_), dtype=f, device=xb.device)
    hprev = []
    for c in range(nc):
        hprev.append(hstate)
        hstate = hstate * decay[:, c] + binp[:, c]
    gstate = dh.to(f)
    dstate = [None] * nc
    for c in reversed(range(nc)):
        dstate[c] = gstate
        gstate = gstate * decay[:, c] + dinp[:, c]
    hp = torch.stack(hprev, dim=1)                              # (B,NC,H,N,P)
    gh = torch.stack(dstate, dim=1)

    dm = torch.einsum("bcihp,bcjhp->bcijh", gy, xb) * tri[..., None]
    dcb = dm * big_l
    bdh = torch.einsum("bcjn,bchnp->bcjhp", bm, gh)             # B dH
    dx = torch.einsum("bcijh,bcihp->bcjhp", m, gy) + w[..., None] * bdh
    dc = (torch.einsum("bcijh,bcjn->bcin", dcb, bm)
          + torch.einsum("bcihp,bchnp->bcin", el[..., None] * gy, hp))
    db = (torch.einsum("bcijh,bcin->bcjn", dcb, cm)
          + torch.einsum("bcjhp,bchnp->bcjn", w[..., None] * xb, gh))
    g = dm * m
    r = (w[..., None] * xb * bdh).sum(-1)                       # (B,NC,Q,H)
    chp = torch.einsum("bcin,bchnp->bcihp", cm, hp)             # C H_prev
    dl = g.sum(3) - g.sum(2) + el * (gy * chp).sum(-1) - r
    dl[:, :, -1] += torch.exp(lq) * (hp * gh).sum((-2, -1)) + r.sum(2)
    da = dl.flip(2).cumsum(2).flip(2)

    s_pad = nc * q
    return (dx.reshape(b, s_pad, h, p_)[:, :s].to(xbar.dtype),
            da.reshape(b, s_pad, h)[:, :s].contiguous(),
            db.reshape(b, s_pad, n)[:, :s].to(Bm.dtype),
            dc.reshape(b, s_pad, n)[:, :s].to(Bm.dtype))

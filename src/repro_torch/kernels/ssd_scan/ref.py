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

__all__ = ["ssd_chunk_scan_ref", "chunk_len"]


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

"""The plain reference's segmented engine with the handover that pairs
the two trajectories' emissions as their sequences align (NumPy; the
soft layers, the matched filter and the demod are reference.py's).

reference.Demod.segmented cuts a boundary after the first symbol that
both trajectories emit at rows at most one apart. Where the trajectories
emit one row apart and the overlap window opens on one trajectory's
unpaired emission, that first pair can be two neighbouring symbols whose
labels coincide, and the cut then duplicates or drops a symbol. Here the
anchor is the first pair of the alignment under which the two emission
sequences agree most; every other step is reference.py's.
"""

import numpy as np
import torch

from sdrbench import reference as R

F32 = R.F32
SEG_T = R.SEG_T
ALIGN = 2           # emission offsets tried between the two trajectories


def _emissions(v, s):
    """Labels and rows [T + 1, C] of a trajectory's emissions in order
    (row T past the last), their count [C] and each row's emission index
    [T, C] (-1 before the first)."""
    T, C = v.shape
    k = np.cumsum(v, axis=0) - 1
    at = np.where(v, k, T)
    cols = np.broadcast_to(np.arange(C), (T, C))
    lab = np.zeros((T + 1, C), s.dtype)
    rows = np.full((T + 1, C), T, np.int64)
    lab[at[v], cols[v]] = s[v]
    rows[at[v], cols[v]] = np.broadcast_to(np.arange(T)[:, None], (T, C))[v]
    return lab, rows, v.sum(axis=0), k


def cut(va, sa, vb, sb):
    """The handover row of a boundary's overlap window ([T, C]; the
    incoming labels relabelled) and whether an anchor was found: the row
    after both copies of the first symbol emitted by both trajectories
    at rows at most one apart and paired under their alignment d (|d| <=
    ALIGN, the most agreeing emission offset), before either one's next
    emission; where no alignment has T // 4 agreeing emissions (about
    half the window's), the first such pair of any alignment; with
    none, T."""
    T, C = va.shape
    lanes = np.arange(C)
    c0 = va[:-1] & vb[:-1] & (sa[:-1] == sb[:-1])
    c1 = va[:-1] & vb[1:] & (sa[:-1] == sb[1:]) & ~va[1:]
    c2 = va[1:] & vb[:-1] & (sa[1:] == sb[:-1]) & ~vb[1:]
    anyc = c0 | c1 | c2
    first = np.argmax(anyc, axis=0)
    any_cut = np.where(c0[first, lanes], first + 1, first + 2)
    la, ra, na, ka = _emissions(va, sa)
    lb, rb, nb, _ = _emissions(vb, sb)
    k = np.arange(T)[:, None]
    agree = []
    for d in range(-ALIGN, ALIGN + 1):
        q = k + d
        both = (k < na) & (q >= 0) & (q < nb)
        agree.append((both & (la[:T] == np.take_along_axis(
            lb, np.broadcast_to(np.clip(q, 0, T), (T, C)), 0))).sum(axis=0))
    agree = np.stack(agree)
    d = np.argmax(agree, axis=0) - ALIGN
    p = np.maximum(ka, 0)
    q = p + d[None, :]
    qc = np.clip(q, 0, T)
    w2 = np.take_along_axis(rb, qc, 0)
    c = np.maximum(k, w2) + 1
    ok = (va & (q >= 0) & (q < nb) & (np.abs(k - w2) <= 1)
          & (sa == np.take_along_axis(lb, qc, 0))
          & (c <= np.minimum(np.take_along_axis(ra, p + 1, 0),
                             np.take_along_axis(rb, np.minimum(qc + 1, T),
                                                0))))
    aligned = c[np.argmax(ok, axis=0), lanes]
    strong = agree.max(axis=0) >= T // 4
    found = np.where(strong, ok.any(axis=0), anyc.any(axis=0))
    out = np.where(strong, aligned, any_cut)
    return np.where(found, out, T), found


class Demod(R.Demod):
    """reference.Demod with the segmented engine's handover above."""

    def segmented(self, S: int, W: int, dem_state: np.ndarray,
                  seg_state: np.ndarray, x: torch.Tensor):
        """reference.Demod.segmented with `cut` at each boundary."""
        C = dem_state.shape[1]
        T = SEG_T
        ra = self.readahead
        n = x.shape[1] - ra
        nseg = n // S
        L2 = nseg + T
        pos = R.seg_positions(S, nseg, T)
        b = [(j + 1) * nseg - T - W for j in range(S - 1)]
        gap = np.repeat(np.array([b[j] - pos[j] for j in range(S - 1)], F32),
                        C)
        xs1 = torch.cat([x[:, bj:bj + W + ra] for bj in b])
        offs2 = [0] + [s * nseg - T for s in range(1, S)]
        xs2 = torch.cat([x[:, o:o + L2 + ra] for o in offs2])
        p1 = seg_state[:, :(S - 1) * C].copy()
        adv = R._wrap_u16(R._wrap_u16(p1[2] * F32(128.0))
                          * (gap / F32(128.0)))
        p1[1] = R._wrap_u16(p1[1] + adv)
        st1 = self.run(p1, xs1)[0]
        p2 = np.concatenate([dem_state, st1], axis=1)
        seg_out, sym, valid, cost = self.run(p2, xs2)

        def seg_of(a, s):
            return a[:, s * C:(s + 1) * C]

        def owned(s):
            lo = 0 if s == 0 else T
            return lo, lo + nseg

        def tail(s):
            return (nseg - T, nseg) if s == 0 else (nseg, L2)

        dphase = np.array([0.0, 16384.0, 32768.0, -16384.0], F32)
        sym_corr = [seg_of(sym, 0)]
        masks = []
        seg_rot = [np.zeros(C, F32)]
        rows = np.arange(T)[:, None]
        for s in range(1, S):
            ta, tb = tail(s - 1)
            va = seg_of(valid, s - 1)[ta:tb]
            sa = sym_corr[s - 1][ta:tb]
            vb = seg_of(valid, s)[:T]
            sb_raw = seg_of(sym, s)
            cnt = []
            for r in range(4):
                sbr = R._rot_label(sb_raw[:T], r)
                m = ((va[:-1] & vb[:-1] & (sa[:-1] == sbr[:-1]))
                     | (va[:-1] & vb[1:] & (sa[:-1] == sbr[1:]))
                     | (va[1:] & vb[:-1] & (sa[1:] == sbr[:-1])))
                cnt.append(m.sum(axis=0))
            cnt = np.stack(cnt)
            rhat = np.argmax(cnt, axis=0)
            rhat = np.where(cnt.max(axis=0) >= T // 8, rhat, 0)
            sseg = R._rot_label(sb_raw, rhat)
            seg_rot.append(dphase[rhat])
            sym_corr.append(sseg)
            masks.append(rows >= cut(va, sa, vb, sseg[:T])[0][None, :])
        seg_out = seg_out.copy()
        seg_out[1] = R._wrap_u16(seg_out[1] - np.concatenate(seg_rot))
        dem_state = seg_out[:, (S - 1) * C:].copy()

        def splice(a, segs=None):
            get = segs.__getitem__ if segs else (lambda s: seg_of(a, s))
            out = np.concatenate([get(s)[slice(*owned(s))] for s in range(S)])
            for s in range(1, S):
                ta, tb = tail(s - 1)
                out[s * nseg - T:s * nseg] = np.where(
                    masks[s - 1], get(s)[:T], get(s - 1)[ta:tb])
            return out

        return (dem_state, seg_out, splice(sym, sym_corr), splice(valid),
                splice(cost))

"""Track-major layout: gather-free Schur band assembly for consecutive tracks.

The λ-free pair gather packs W into covisibility-pair order: ~470 MB of
random access per linearization at ladybug-1723. The covisibility
pairs of a *consecutive* camera track are fully determined by the track's
start camera and length: the pair (slot a, slot b) of a track starting at
camera c0 contributes exactly the band block (offset b−a, row c0+a). So
instead of enumerating pairs (quadratic) and gathering W per pair, lay W
out TRACK-MAJOR once per linearization — one O-sized permutation gather
into (27, dmax, Pt) slot order — and produce every per-λ pair product from
*slices* (track_blocks_jnp), reducing into band rows keyed by start camera.

Points whose tracks are not consecutive (loop-closure wraparound, repeated
cameras, very long tracks) fall back to the legacy pair enumeration — for
trajectory-style BAL problems that is ≲1% of points, so the legacy packed
gather shrinks from ~470 MB to a few MB.

Capability parity: part of the reference's Schur-complement camera-system
build (BASELINE.json:5 "block-sparse J^T J assembly"); the layout is new
design, not mirrored from the (MATLAB, empty mount — SURVEY.md §0)
reference.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["slot_idx", "slot_mask", "vperm", "keys"],
    meta_fields=["dmax", "n_tracked", "pt_pad", "n_out"],
)
@dataclasses.dataclass(frozen=True)
class TrackLayout:
    """Static track-major schedule for the band build.

    ``slot_idx[a, p]`` is the observation index of the a-th (camera-order)
    observation of tracked point p (points in start-camera-sorted order);
    ``slot_mask[a, p]`` is 1.0 where a < track length (0.0 ⇒ the slot's W
    must be treated as zero); ``vperm[p]`` is the original point id (for the
    V gather); ``keys[p]`` is the start camera (sorted ascending; padding
    rows carry n_cameras−1 with all-zero masks); slot pair (a, b) reduces
    by key+a.
    """

    slot_idx: jax.Array    # (dmax, Pt_pad) int32
    slot_mask: jax.Array   # (dmax, Pt_pad) float32
    vperm: jax.Array       # (Pt_pad,) int32
    keys: jax.Array        # (Pt_pad,) int32, sorted
    dmax: int
    n_tracked: int
    pt_pad: int
    n_out: int             # c_pad — width of one band row


def split_tracks(cam_idx, pt_idx, n_obs: int, n_points: int,
                 *, dmax_cap: int = 8):
    """Classify points: tracked (consecutive cameras, length ≤ dmax_cap)
    vs legacy. Returns (tracked_mask (P,), order, starts, deg) where
    ``order`` sorts observations stably by point and ``starts``/``deg``
    index each point's run in that order."""
    ci = np.asarray(cam_idx)[:n_obs].astype(np.int64)
    pi = np.asarray(pt_idx)[:n_obs].astype(np.int64)
    # the span test below (cam_last − cam_first == deg−1 ⇔ consecutive) is
    # sound only when observations are camera-sorted within each point —
    # guaranteed by the global camera sort (make_problem sort=True). With
    # unsorted input (e.g. make_problem(..., sort=False)) an order like
    # [1,3,2,4] would silently pass and produce wrong band blocks, so
    # verify the invariant cheaply and fall back to legacy pairs otherwise
    # [ADVICE r3 low #2].
    if ci.size and not np.all(np.diff(ci) >= 0):
        none = np.zeros(n_points, bool)
        order = np.argsort(pi, kind="stable").astype(np.int64)
        deg = np.bincount(pi[order], minlength=n_points)
        starts = np.concatenate([[0], np.cumsum(deg)])[:-1]
        return none, order, starts, deg
    order = np.argsort(pi, kind="stable").astype(np.int64)
    pis = pi[order]
    deg = np.bincount(pis, minlength=n_points)
    starts = np.concatenate([[0], np.cumsum(deg)])[:-1]
    cis = ci[order]
    has = deg > 0
    cam_first = np.zeros(n_points, np.int64)
    cam_last = np.zeros(n_points, np.int64)
    cam_first[has] = cis[starts[has]]
    cam_last[has] = cis[starts[has] + deg[has] - 1]
    # observations are camera-sorted globally, so within a point the camera
    # sequence is ascending; distinct cameras + span == deg−1 ⇔ consecutive
    # (any repeated camera shrinks the span below deg−1 ⇒ legacy)
    tracked = has & (deg <= dmax_cap) & (cam_last - cam_first == deg - 1)
    return tracked, order, starts, deg


def build_track_layout(cam_idx, pt_idx, n_obs: int, n_cameras: int,
                       n_points: int, c_pad: int, *, dmax_cap: int = 8,
                       tile: int = 2048):
    """Build the TrackLayout (or None if no point is tracked)."""
    tracked, order, starts, deg = split_tracks(
        cam_idx, pt_idx, n_obs, n_points, dmax_cap=dmax_cap)
    ptids = np.nonzero(tracked)[0]
    if ptids.size == 0:
        return None
    ci = np.asarray(cam_idx)[:n_obs].astype(np.int64)
    c0 = ci[order[starts[ptids]]]
    sort = np.argsort(c0, kind="stable")
    ptids = ptids[sort]
    c0 = c0[sort]
    d = deg[ptids]
    dmax = int(d.max())
    if n_cameras + dmax > c_pad:
        raise ValueError(
            f"c_pad {c_pad} too small for key shift: need ≥ "
            f"{n_cameras + dmax} (build the band grid with margin)")

    nt = int(ptids.size)
    pt_pad = _round_up(nt, tile)
    pad = pt_pad - nt

    slot_idx = np.zeros((dmax, pt_pad), np.int64)
    slot_mask = np.zeros((dmax, pt_pad), np.float32)
    base = starts[ptids]
    for a in range(dmax):
        ok = d > a
        slot_idx[a, :nt][ok] = order[base[ok] + a]
        slot_mask[a, :nt][ok] = 1.0
    keys = np.concatenate([c0, np.full(pad, n_cameras - 1, np.int64)])
    vperm = np.concatenate([ptids, np.zeros(pad, np.int64)])

    return TrackLayout(
        slot_idx=jnp.asarray(slot_idx.astype(np.int32)),
        slot_mask=jnp.asarray(slot_mask),
        vperm=jnp.asarray(vperm.astype(np.int32)),
        keys=jnp.asarray(keys.astype(np.int32)),
        dmax=dmax, n_tracked=nt, pt_pad=pt_pad, n_out=int(c_pad),
    )


def shard_stack_track_layout(layout: TrackLayout, n_dev: int, *,
                             tile: int = 2048) -> TrackLayout:
    """Split a global TrackLayout into ``n_dev`` per-device layouts and
    stack them with a leading device axis.

    The tracked points are start-camera-sorted, so a contiguous chunk of
    layout columns is a contiguous band-row range per device; each device
    emits full-width band partials that psum exactly like the pair-block
    psum (tpu_ba/solver/pairs.py solve_schur_sparse). ``slot_idx`` holds
    GLOBAL observation ids — the sharded pack gathers from the
    per-linearization all-gathered W, same as the pair gather."""
    nt = layout.n_tracked
    nd = -(-max(nt, 1) // n_dev)                   # columns per device
    pt_pad_dev = _round_up(nd, tile)
    slot_idx = np.asarray(layout.slot_idx)
    slot_mask = np.asarray(layout.slot_mask)
    vperm = np.asarray(layout.vperm)
    keys = np.asarray(layout.keys)
    fill_key = int(keys[max(nt - 1, 0)])           # keeps keys sorted

    si, sm, vp, ky = [], [], [], []
    for d in range(n_dev):
        lo, hi = d * nd, min((d + 1) * nd, nt)
        w = max(hi - lo, 0)
        pad = pt_pad_dev - w
        k_dev = keys[lo:hi]
        fill = int(k_dev[-1]) if w else fill_key
        si.append(np.pad(slot_idx[:, lo:hi], ((0, 0), (0, pad))))
        sm.append(np.pad(slot_mask[:, lo:hi], ((0, 0), (0, pad))))
        vp.append(np.pad(vperm[lo:hi], (0, pad)))
        ky.append(np.concatenate([k_dev, np.full(pad, fill, k_dev.dtype)]))
    return TrackLayout(
        slot_idx=jnp.asarray(np.stack(si).astype(np.int32)),
        slot_mask=jnp.asarray(np.stack(sm).astype(np.float32)),
        vperm=jnp.asarray(np.stack(vp).astype(np.int32)),
        keys=jnp.asarray(np.stack(ky).astype(np.int32)),
        dmax=layout.dmax, n_tracked=nt, pt_pad=pt_pad_dev,
        n_out=layout.n_out,
    )


def unstack_track_layout(layout: TrackLayout) -> TrackLayout:
    """Inside shard_map: drop the leading (length-1) device axis of a
    stacked TrackLayout."""
    return dataclasses.replace(
        layout,
        slot_idx=layout.slot_idx[0], slot_mask=layout.slot_mask[0],
        vperm=layout.vperm[0], keys=layout.keys[0])


def gather_track_data(W, V, layout: TrackLayout):
    """λ-free per-linearization pack: W into slot order (one O-sized
    permutation gather — the whole point of the layout), V into
    start-sorted point order. Returns (Wt (27, dmax, Pt_pad),
    Vt (9, Pt_pad))."""
    Wt = W[:, layout.slot_idx]                 # (27, dmax, Pt_pad)
    Vt = V[:, layout.vperm]                    # (9, Pt_pad)
    return Wt, Vt


def track_blocks_jnp(Wt, Vt, lam, layout: TrackLayout, dc: int,
                     diag_floor: float, diag_ceil: float):
    """Band blocks of the tracked points: per-slot-pair products reduced by
    start camera. Returns (dmax·dc², n_out)."""
    from tpu_ba.solver.schur import inv3x3_rows

    d2 = dc * dc
    dmax = layout.dmax
    V = Vt
    dV = jnp.clip(jnp.stack([V[0], V[4], V[8]]), diag_floor, diag_ceil)
    Vl = V.at[0].add(lam * dV[0]).at[4].add(lam * dV[1]).at[8].add(lam * dV[2])
    Vinv = inv3x3_rows(Vl)                                  # (9, Pt)

    out = jnp.zeros((dmax * d2, layout.n_out), Wt.dtype)
    for a in range(dmax):
        Wa = Wt[:, a, :] * layout.slot_mask[a][None, :]
        M = jnp.stack([
            sum(Wa[3 * m + a2] * Vinv[3 * a2 + b2] for a2 in range(3))
            for m in range(dc) for b2 in range(3)
        ])                                                   # (3dc, Pt)
        for b in range(a, dmax):
            off = b - a
            Wb = Wt[:, b, :] * layout.slot_mask[b][None, :]
            vals = jnp.stack([
                sum(M[3 * m + b2] * Wb[3 * n + b2] for b2 in range(3))
                for m in range(dc) for n in range(dc)
            ])                                               # (d2, Pt)
            seg = jax.ops.segment_sum(
                vals.T, layout.keys + a, layout.n_out,
                indices_are_sorted=True).T                   # (d2, n_out)
            out = out.at[off * d2:(off + 1) * d2].add(seg)
    return out

"""Slot-major layout: gather-free band assembly for ARBITRARY short tracks.

The track-major path (tpu_ba/solver/tracks.py) removed the quadratic
covisibility-pair gather for points whose cameras form a CONSECUTIVE run —
but windowed problems with visibility dropouts (the Venice stand-in) leave
~40% of observations on the legacy pair path, whose quadratic gather
(~17M indices per linearization on the Venice stand-in) dominated.

Slot-major drops the consecutiveness requirement: any point whose
(ascending) camera set spans ≤ SLOT_SPAN_CAP indices, has degree ≤
SLOT_DEG_CAP and distinct cameras is packed into degree-bucketed dense
slot arrays

    W_b (27, d, P_b)   cam_b (d, P_b)   V_b (9, P_b)

with ONE O-sized permutation gather per linearization. The per-λ build
(slot_blocks_jnp) forms every pair product W_a V_λ⁻¹ W_cᵀ from SLICES — no
per-pair indices exist anywhere — and reduces in two levels:

  level 1: a segment sum into a TILE-LOCAL grid
      local = (cam_a − tile_base_row)·n_off_loc + (cam_c − cam_a).
      The grid width is (tile_row_spread + span)·n_off_loc, so each bucket
      picks the largest tile in TILE_OPTS that keeps width ≤ WIDTH_BUDGET;
      buckets too small/sparse to localize stay on the legacy pair path
      (their pair count is tiny by construction).
  level 2 (host-planned): the concatenated tile grids carry statically
      known global band keys off·c_pad + row; a host-sorted permutation +
      a sorted segment sum folds them into the SAME (dc², k_band) band
      layout the pair/track paths produce, so the banded CG matvec is
      untouched.

Tracks and slots COMPOSE: consecutive points keep the cheaper track path,
slots take the remaining eligible points, legacy pairs the rest
(tests/test_slots.py).

Capability parity: the reference's Schur-complement camera-system build
(BASELINE.json:5 "block-sparse J^T J assembly"); the layout is new design
(reference mount empty — SURVEY.md §0).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

SLOT_SPAN_CAP = 16    # max (cam_last − cam_first) of an eligible point
SLOT_DEG_CAP = 16     # max track length of an eligible point
WIDTH_BUDGET = 1280   # max level-1 local grid width (lanes)
TILE_OPTS = (2048, 1024, 512)

# degree-bucket upper edges: a point of degree d lands in the smallest
# bucket ≥ d (extra slots masked). Each accepted bucket is traced into its
# own set of ops — few buckets keeps compile time bounded.
BUCKET_EDGES = (2, 3, 4, 5, 6, 8, 12, 16)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["slot_idx", "slot_cam", "slot_mask", "vperm", "tile_base",
                 "l2_perm", "l2_keys"],
    meta_fields=["degrees", "tiles", "widths", "pt_pad", "n_off_loc",
                 "n_tracked", "l2_len", "n_out"],
)
@dataclasses.dataclass(frozen=True)
class SlotLayout:
    """Static slot-major schedule for the band build.

    Per accepted bucket k (degree edge d = degrees[k], tile size tiles[k],
    local width widths[k]):
      slot_idx[k]  (d, Pk)  observation index of slot a (points sorted by
                            start camera; padding points repeat the last)
      slot_cam[k]  (d, Pk)  camera id per slot (int32)
      slot_mask[k] (d, Pk)  1.0 where slot < true degree
      vperm[k]     (Pk,)    original point id (V gather)
      tile_base[k] (Tk,)    per-tile base row (min camera of the tile)
    Shared:
      n_off_loc    dense local offset count (SLOT_SPAN_CAP + 1)
      l2_perm      (L,) permutation of the concatenated level-1 columns
                   into global-band-key-sorted order
      l2_keys      (L,) sorted global keys (off_idx·c_pad + row; trash =
                   n_out for dead local slots)
      n_out        k_band (+1 trash segment in the reduction)
    """

    slot_idx: tuple
    slot_cam: tuple
    slot_mask: tuple
    vperm: tuple
    tile_base: tuple
    l2_perm: jax.Array
    l2_keys: jax.Array
    degrees: tuple
    tiles: tuple
    widths: tuple
    pt_pad: tuple
    n_off_loc: int
    n_tracked: int
    l2_len: int
    n_out: int


def slot_eligible(cam_idx, pt_idx, n_obs: int, n_points: int):
    """Classify points for the slot path. Returns (mask (P,), order, starts,
    deg, span) — mask True where degree ≤ SLOT_DEG_CAP, camera span ≤
    SLOT_SPAN_CAP, and all slot cameras are distinct (duplicate (cam, pt)
    observations go legacy: the symmetric pair orientation relies on
    distinct cameras). Requires globally camera-sorted observations (the
    make_problem invariant); falls back to nothing-eligible otherwise."""
    ci = np.asarray(cam_idx)[:n_obs].astype(np.int64)
    pi = np.asarray(pt_idx)[:n_obs].astype(np.int64)
    order = np.argsort(pi, kind="stable").astype(np.int64)
    pis = pi[order]
    deg = np.bincount(pis, minlength=n_points)
    starts = np.concatenate([[0], np.cumsum(deg)])[:-1]
    if ci.size and not np.all(np.diff(ci) >= 0):
        return (np.zeros(n_points, bool), order, starts, deg,
                np.zeros(n_points, np.int64))
    cis = ci[order]
    has = deg > 0
    span = np.zeros(n_points, np.int64)
    dup = np.zeros(n_points, bool)
    for d in np.unique(deg):
        if d == 0:
            continue
        pts = np.nonzero(deg == d)[0]
        mat = cis[starts[pts][:, None] + np.arange(d)[None, :]]
        span[pts] = mat.max(axis=1) - mat.min(axis=1)
        if d > 1:
            dup[pts] = (np.diff(mat, axis=1) == 0).any(axis=1)
    ok = has & (deg <= SLOT_DEG_CAP) & (span <= SLOT_SPAN_CAP) & ~dup
    return ok, order, starts, deg, span


@dataclasses.dataclass
class SlotBuckets:
    """Host-side phase-a output: accepted bucket arrays, before the band
    layout (offsets, c_pad) is known."""

    accepted_pts: np.ndarray     # (P,) bool — points the slot path owns
    degrees: list
    tiles: list
    widths: list
    sidx: list
    scam: list
    smask: list
    vperm: list
    tile_base: list
    pt_pad: list
    span_max: int
    n_tracked: int


def select_slot_buckets(cam_idx, pt_idx, n_obs: int, n_points: int, *,
                        elig=None, candidate_mask=None) -> SlotBuckets | None:
    """Phase a: bucket the slot-candidate points by degree and build the
    dense slot arrays. A bucket is accepted only if some tile size in
    TILE_OPTS keeps its level-1 width ≤ WIDTH_BUDGET; rejected buckets'
    points stay on the legacy pair path."""
    if elig is None:
        elig = slot_eligible(cam_idx, pt_idx, n_obs, n_points)
    ok, order, starts, deg, span = elig
    if candidate_mask is not None:
        ok = ok & candidate_mask
    ptids_all = np.nonzero(ok)[0]
    if ptids_all.size == 0:
        return None
    ci = np.asarray(cam_idx)[:n_obs].astype(np.int64)
    n_off_loc = SLOT_SPAN_CAP + 1

    edges = np.asarray(BUCKET_EDGES)
    bidx = np.searchsorted(edges, deg[ptids_all])
    out = SlotBuckets(
        accepted_pts=np.zeros(n_points, bool), degrees=[], tiles=[],
        widths=[], sidx=[], scam=[], smask=[], vperm=[], tile_base=[],
        pt_pad=[], span_max=0, n_tracked=0)
    for k, d_edge in enumerate(BUCKET_EDGES):
        pts = ptids_all[bidx == k]
        if pts.size == 0:
            continue
        d = int(d_edge)
        c0 = ci[order[starts[pts]]]
        srt = np.argsort(c0, kind="stable")
        pts, c0 = pts[srt], c0[srt]
        nt = pts.size
        base = starts[pts]
        dp = deg[pts]
        # row reach per point = max slot camera (for width sizing)
        cmax = np.zeros(nt, np.int64)
        sidx = np.zeros((d, nt), np.int64)
        scam = np.zeros((d, nt), np.int64)
        smask = np.zeros((d, nt), np.float32)
        for a in range(d):
            have = dp > a
            rows = order[base[have] + a]
            sidx[a, have] = rows
            scam[a, have] = ci[rows]
            smask[a, have] = 1.0
            # masked slots reuse the point's first camera: keys stay in
            # range and the zeroed W kills the contribution exactly
            sidx[a, ~have] = order[base[~have]]
            scam[a, ~have] = c0[~have]
            cmax = np.maximum(cmax, scam[a])
        tile_b = width_b = None
        for t in TILE_OPTS:
            pp = _round_up(nt, t)
            n_tiles = pp // t
            c0p = np.concatenate([c0, np.full(pp - nt, c0[-1])])
            cmaxp = np.concatenate([cmax, np.full(pp - nt, cmax[-1])])
            tb = c0p.reshape(n_tiles, t).min(axis=1)
            spread = (cmaxp.reshape(n_tiles, t).max(axis=1) - tb + 1)
            w = _round_up(int(spread.max()) * n_off_loc, 128)
            if w <= WIDTH_BUDGET:
                tile_b, width_b = t, w
                break
        if tile_b is None:
            continue                       # too sparse to localize → legacy
        pp = _round_up(nt, tile_b)
        pad = pp - nt
        if pad:
            sidx = np.concatenate(
                [sidx, np.broadcast_to(sidx[:, -1:], (d, pad))], axis=1)
            scam = np.concatenate(
                [scam, np.broadcast_to(scam[:, -1:], (d, pad))], axis=1)
            smask = np.concatenate([smask, np.zeros((d, pad), np.float32)],
                                   axis=1)
        tb = scam[0].reshape(pp // tile_b, tile_b).min(axis=1)
        # base must bound EVERY slot row from below: slot 0 of a masked
        # point is its c0, the minimum over its slots, so min over slot 0
        # of the tile is the tile minimum
        out.accepted_pts[pts] = True
        out.degrees.append(d)
        out.tiles.append(tile_b)
        out.widths.append(width_b)
        out.sidx.append(sidx)
        out.scam.append(scam)
        out.smask.append(smask)
        out.vperm.append(np.concatenate([pts, np.zeros(pad, np.int64)]))
        out.tile_base.append(tb)
        out.pt_pad.append(pp)
        out.span_max = max(out.span_max, int(span[pts].max()))
        out.n_tracked += nt
    if not out.degrees:
        return None
    return out


def finalize_slot_layout(b: SlotBuckets, band_offsets: tuple,
                         c_pad: int) -> SlotLayout:
    """Phase b: the level-2 fold schedule, once the band layout is known.
    build_pair_plan protects offsets 0..span_max through the 32-offset cap,
    so every slot offset has a band slot by construction."""
    n_off_loc = SLOT_SPAN_CAP + 1
    n_out = len(band_offsets) * c_pad
    off_to_idx = np.full(max(max(band_offsets), n_off_loc - 1) + 1, -1,
                         np.int64)
    off_to_idx[np.asarray(band_offsets)] = np.arange(len(band_offsets))
    keys_parts = []
    for k in range(len(b.degrees)):
        width = b.widths[k]
        tb = b.tile_base[k]
        loc = np.arange(width)
        r_loc, off = loc // n_off_loc, loc % n_off_loc
        oi = off_to_idx[off]                               # −1 ⇒ no band slot
        row = tb[:, None] + r_loc[None, :]                 # (Tk, width)
        key = np.where((oi[None, :] >= 0) & (row < c_pad),
                       oi[None, :] * c_pad + row, n_out)   # trash = n_out
        keys_parts.append(key.reshape(-1))
    keys_flat = np.concatenate(keys_parts)
    L = keys_flat.shape[0]
    l2_perm = np.argsort(keys_flat, kind="stable")
    l2_keys = keys_flat[l2_perm]
    L_pad = _round_up(L, 1024)
    if L_pad != L:
        # padding columns duplicate the last column but carry the trash key
        # n_out ≥ every real key, so sortedness holds and they reduce to
        # the dropped trash segment
        l2_perm = np.concatenate([l2_perm, np.full(L_pad - L, L - 1)])
        l2_keys = np.concatenate([l2_keys, np.full(L_pad - L, n_out)])

    return SlotLayout(
        slot_idx=tuple(jnp.asarray(s.astype(np.int32)) for s in b.sidx),
        slot_cam=tuple(jnp.asarray(s.astype(np.int32)) for s in b.scam),
        slot_mask=tuple(jnp.asarray(s) for s in b.smask),
        vperm=tuple(jnp.asarray(v.astype(np.int32)) for v in b.vperm),
        tile_base=tuple(jnp.asarray(t.astype(np.int32)) for t in b.tile_base),
        l2_perm=jnp.asarray(l2_perm.astype(np.int32)),
        l2_keys=jnp.asarray(l2_keys.astype(np.int32)),
        degrees=tuple(b.degrees), tiles=tuple(b.tiles),
        widths=tuple(b.widths), pt_pad=tuple(b.pt_pad),
        n_off_loc=int(n_off_loc), n_tracked=int(b.n_tracked),
        l2_len=int(L_pad), n_out=int(n_out),
    )


def gather_slot_data(W, V, layout: SlotLayout):
    """λ-free per-linearization pack: W into slot order (ONE O-sized
    permutation gather per bucket — the point of the layout), V into
    start-sorted point order. Returns ([(27, d, Pk)], [(9, Pk)])."""
    Ws = [W[:, si] for si in layout.slot_idx]
    Vs = [V[:, vp] for vp in layout.vperm]
    return Ws, Vs


def slot_blocks_jnp(Ws, Vs, lam, layout: SlotLayout, dc: int,
                    diag_floor: float, diag_ceil: float):
    """Band blocks of the slot points (level 1 + 2 reductions). Returns
    (dc², n_out) band-grid contributions (off-major, like the pair
    path's blk[:, :k_band])."""
    from tpu_ba.solver.schur import inv3x3_rows

    d2 = dc * dc
    parts = []
    for k, d in enumerate(layout.degrees):
        Wt, Vt = Ws[k], Vs[k]
        mask = layout.slot_mask[k]
        camt = layout.slot_cam[k]
        width = layout.widths[k]
        tile = layout.tiles[k]
        V = Vt
        dV = jnp.clip(jnp.stack([V[0], V[4], V[8]]), diag_floor, diag_ceil)
        Vl = (V.at[0].add(lam * dV[0]).at[4].add(lam * dV[1])
              .at[8].add(lam * dV[2]))
        Vinv = inv3x3_rows(Vl)                               # (9, Pk)
        Pk = Wt.shape[-1]
        n_tiles = Pk // tile
        base = jnp.repeat(layout.tile_base[k], tile)         # (Pk,)
        tix = jnp.arange(Pk) // tile
        out_k = jnp.zeros((d2, n_tiles * width), Wt.dtype)
        for a in range(d):
            Wa = Wt[:, a, :] * mask[a][None, :]
            M = jnp.stack([
                sum(Wa[3 * m + a2] * Vinv[3 * a2 + b2] for a2 in range(3))
                for m in range(dc) for b2 in range(3)
            ])
            for b in range(a, d):
                Wb = Wt[:, b, :] * mask[b][None, :]
                vals = jnp.stack([
                    sum(M[3 * m + b2] * Wb[3 * n + b2] for b2 in range(3))
                    for m in range(dc) for n in range(dc)
                ])                                           # (d2, Pk)
                # masked pairs can go negative (their values are zero) —
                # clamp so segment_sum indices stay in range
                local = jnp.clip((camt[a] - base) * layout.n_off_loc
                                 + (camt[b] - camt[a]), 0, width - 1)
                gkey = tix * width + local
                out_k = out_k + jax.ops.segment_sum(
                    (vals * (mask[a] * mask[b])[None, :]).T, gkey,
                    n_tiles * width).T
        parts.append(out_k)
    l1 = jnp.concatenate(parts, axis=1)                       # (d2, L)
    l1 = jnp.pad(l1, ((0, 0), (0, layout.l2_len - l1.shape[1])))
    l1s = l1[:, layout.l2_perm]
    out = jax.ops.segment_sum(l1s.T, layout.l2_keys, layout.n_out + 1,
                              indices_are_sorted=True).T
    return out[:, : layout.n_out]

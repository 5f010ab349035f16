"""Explicit dense Schur complement via a static covisibility-pair plan.

Capability parity: the reference's Schur-complement camera solve
(BASELINE.json:5 "Schur-complement elimination of points"; SURVEY.md §2.1 R4)
— here in the *explicit* form S = U_λ − W V_λ⁻¹ Wᵀ, for BAL-class problems
(C ≤ a few thousand cameras).

Why explicit: the matrix-free matvec (tpu_ba/solver/schur.py) does two
O-sized gathers and two segment-sums *per CG iteration*; building S once per
λ-retry turns every CG iteration into a pass over the covisible camera
blocks only. All λ-dependent work happens in *pair space* with zero
gathers: the static plan enumerates, for every point p and every ordered
observation pair (i, j) of p, the contribution W_i V_λ,p⁻¹ W_jᵀ to camera
block (cam_i, cam_j) of S. The 3×3 point-block inverses are *recomputed per
pair* (≈60 FLOPs each) instead of gathered per λ-retry.

Per linearization (λ-free, once): gather W and V blocks into pair order.
Per λ-retry: damp + invert 3×3s in pair space → 6×6 pair products →
one sorted segment-sum into dense S → block-Jacobi PCG on S.

The matrix-free path (tpu_ba/solver/schur.py) remains the distributed and
large-C fallback and the correctness oracle.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_ba.solver.batched_linalg import inv_spd_small
from tpu_ba.solver.normal import BlockSystem, damp_blocks
from tpu_ba.solver.schur import back_substitute, inv3x3_rows, schur_rhs


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["pair_i", "pair_j", "pair_pt", "pair_key",
                 "pair_seg", "seg_ci", "seg_cj", "diag_pos",
                 "heavy_obs", "heavy_cam", "heavy_seg", "heavy_pt_ids",
                 "nondiag", "track", "slot"],
    meta_fields=["n_pairs", "n_cameras", "max_degree",
                 "n_segments", "k_pad", "n_heavy_obs", "n_heavy_pts",
                 "symmetric", "banded", "band_offsets", "c_pad", "k_band"],
)
@dataclasses.dataclass(frozen=True)
class PairPlan:
    """Static covisibility-pair schedule (row-sorted: key = ci·C + cj).

    Padding pairs carry key == C² (a trash segment sliced off after the
    reduction), so they never touch S regardless of their gathered values.

    The *compact* fields index the K distinct covisible camera pairs (the
    nonzero 9×9 blocks of S) instead of the dense C² grid: ``pair_seg`` maps
    each pair to its compact segment 0..K-1 (padding → k_pad−1, zeroed after
    the reduction), ``seg_ci``/``seg_cj`` give each segment's camera pair
    (padding segments carry ci == C, a trash row for the matvec reduction),
    and ``diag_pos`` locates camera c's (c, c) block.
    """

    pair_i: jax.Array    # (Np,) int32 — observation index of the row side
    pair_j: jax.Array    # (Np,) int32 — observation index of the column side
    pair_pt: jax.Array   # (Np,) int32 — shared point id
    pair_key: jax.Array  # (Np,) int32 — ci·C + cj, ascending; C² on padding
    pair_seg: jax.Array  # (Np,) int32 — compact segment id, ascending
    seg_ci: jax.Array    # (k_pad,) int32 — row camera per segment; C on pad
    seg_cj: jax.Array    # (k_pad,) int32 — col camera per segment; 0 on pad
    diag_pos: jax.Array  # (C,) int32 — segment id of block (c, c); k_pad−1 if absent
    # hybrid heavy-track extension: points whose track length exceeds
    # max_degree are NOT pair-enumerated (quadratic blowup); their S-term
    # W V_λ⁻¹ Wᵀ is applied matrix-free per CG iteration over just their
    # observations (empty arrays when every track fits)
    heavy_obs: jax.Array     # (Oh,) int32 — observation ids of heavy points
    heavy_cam: jax.Array     # (Oh,) int32 — camera id per heavy observation
    heavy_seg: jax.Array     # (Oh,) int32 — compact heavy-point id; n_heavy_pts on padding
    heavy_pt_ids: jax.Array  # (Ph,) int32 — global point id per compact heavy id
    n_pairs: int         # padded pair count
    n_cameras: int
    max_degree: int
    n_segments: int      # K — true number of covisible camera pairs
    k_pad: int           # padded segment count (multiple of the matvec tile)
    n_heavy_obs: int     # true heavy observation count (0 ⇒ no hybrid term)
    n_heavy_pts: int     # number of heavy points
    # symmetric storage (S = Sᵀ): only ci ≤ cj blocks are enumerated — half
    # the pair data and per-λ build work; the matvec adds a transposed pass
    # reduced by COLUMN camera
    symmetric: bool = False
    nondiag: jax.Array | None = None      # (k_pad,) 1.0 off-diag, 0.0 diag
    # banded layout (symmetric only): the first len(band_offsets)·c_pad
    # segments are a DENSE (offset, ci) grid — segment o·c_pad + c holds
    # block T_{c, c+band_offsets[o]} (zero when absent) — so the CG matvec
    # over them is pure static rolls + FMAs with no gathers at all; the
    # off-band remainder lives in segments [k_band, k_pad) sorted by (ci,cj)
    # and runs through the generic compact gather path (it is tiny for
    # trajectory-style problems: ring wraparounds / loop closures)
    banded: bool = False
    band_offsets: tuple = ()   # ascending, band_offsets[0] == 0 when banded
    c_pad: int = 0             # camera lane padding of the band grid
    k_band: int = 0            # len(band_offsets) * c_pad
    # track-major extension (tpu_ba/solver/tracks.py): points with
    # consecutive camera tracks are NOT pair-enumerated — their band
    # contributions come from the gather-free track path; only the
    # leftover (wraparound / irregular) points go through the pair gather
    track: object = None       # TrackLayout | None
    # slot-major extension (tpu_ba/solver/slots.py): generalizes the track
    # split to ARBITRARY short tracks (span ≤ 16, any gaps) — the dominant
    # structure of windowed problems with visibility dropouts (the Venice
    # stand-in), where the quadratic pair gather dominated the linearization
    # on the Venice stand-in). COMPOSES with ``track``: consecutive
    # points keep the cheaper track path, slots take the rest of the
    # eligible points, legacy pairs the remainder.
    slot: object = None        # SlotLayout | None


def build_pair_plan(cam_idx, pt_idx, n_obs: int, n_cameras: int, n_points: int,
                    *, max_degree: int = 64,
                    pad_multiple: int = 2048,
                    symmetric: bool = False,
                    banded: bool = True,
                    tracks: bool | None = None,
                    slots: bool | None = None) -> PairPlan:
    """Host-side plan: enumerate observation pairs sharing a point, sorted by
    camera-pair key. Points whose track length exceeds ``max_degree``
    (quadratic pair blowup) are split off into the *heavy* set: their
    observations are recorded verbatim and their S-contribution is applied
    matrix-free inside the CG matvec instead of being pair-materialized
    (the hybrid path — VERDICT.md round 1, next #2).

    ``symmetric`` enumerates only the ci ≤ cj half of each pair (S = Sᵀ) —
    half the pair data and per-λ build FLOPs; the matvec then applies the
    transposed blocks in a second cj-keyed reduction pass. At Venice-1778
    scale this halves the packed pair gather (9.1 GB → 4.6 GB).

    ``banded`` (symmetric only): lay the compact segments out as a dense
    (offset, ci) band grid for every camera offset cj−ci that is populated
    across ≥ C/8 cameras. Trajectory-style problems (the Ladybug/Venice
    ring stand-ins; any RCM-ordered scene) put ~99.9% of pairs in a few
    offsets, so the CG matvec over the band needs NO gathers — static rolls
    and FMAs only, instead of two (dc, k_pad) gathers per CG iteration."""
    ci = np.asarray(cam_idx)[:n_obs].astype(np.int64)
    pi = np.asarray(pt_idx)[:n_obs].astype(np.int64)

    order = np.argsort(pi, kind="stable").astype(np.int64)
    pi_sorted = pi[order]
    deg = np.bincount(pi_sorted, minlength=n_points)
    dmax = int(deg.max()) if deg.size else 0
    starts = np.concatenate([[0], np.cumsum(deg)])[:-1]

    # track-major split (tpu_ba/solver/tracks.py): points whose cameras form
    # a CONSECUTIVE run skip pair enumeration entirely — their band
    # contributions come from the gather-free track path; zeroing their
    # degree here removes them from both the heavy set and the pair loop
    if tracks is None:
        tracks = bool(symmetric and banded)
    # explicit slots=True engages regardless of size (tests/small scenes);
    # the auto default applies a minimum-coverage threshold so tiny
    # problems don't pay extra compiles for nothing
    slot_min = 0 if slots is True else 4096
    if slots is None:
        # tracks=False is the established "pure pair enumeration" switch
        # (tests, sharded path): slots follow it unless set explicitly
        slots = tracks
    trk_mask = None
    trk_dmax = 0
    covered_obs = 0
    if tracks and symmetric and banded:
        from tpu_ba.solver.tracks import split_tracks

        tm, _, _, _ = split_tracks(cam_idx, pt_idx, n_obs, n_points)
        # coverage threshold (auto mode only): a handful of COINCIDENTAL
        # consecutive tracks on an unstructured problem (shuffled community
        # IDs) must not force the banded layout — that skipped the
        # band-coverage admission and produced a useless 32-offset band
        # with ~everything off-band
        trk_obs = int(deg[tm].sum()) if tm.any() else 0
        trk_min = int(0.05 * max(n_obs, 1))
        if tm.any() and trk_obs >= max(trk_min, 1):
            trk_mask = tm
            trk_dmax = int(deg[tm].max())
            covered_obs += trk_obs
            deg = deg.copy()
            deg[tm] = 0

    # slot-major split (tpu_ba/solver/slots.py): generalizes tracks to
    # arbitrary short tracks (gaps allowed). COMPOSES with tracks: the
    # consecutive points keep the cheaper track path, slots take the
    # remaining eligible points (the dominant share on windowed problems
    # with visibility dropouts — the Venice stand-in), legacy pairs the rest.
    slot_buckets = None
    slot_span_max = 0
    if slots and symmetric and banded:
        from tpu_ba.solver.slots import select_slot_buckets, slot_eligible

        elig = slot_eligible(cam_idx, pt_idx, n_obs, n_points)
        if (elig[0] & (deg > 0)).sum() >= max(slot_min, 1):
            sb = select_slot_buckets(cam_idx, pt_idx, n_obs, n_points,
                                     elig=elig, candidate_mask=deg > 0)
            if sb is not None and sb.n_tracked >= slot_min:
                slot_buckets = sb
                slot_span_max = sb.span_max
                covered_obs += int(deg[sb.accepted_pts].sum())
                deg = deg.copy()
                deg[sb.accepted_pts] = 0

    # heavy points: matrix-free side channel, excluded from pair enumeration
    heavy_mask = deg > max_degree
    heavy_pt_ids = np.nonzero(heavy_mask)[0].astype(np.int64)
    n_heavy_pts = int(heavy_pt_ids.shape[0])
    if n_heavy_pts:
        is_heavy_obs = heavy_mask[pi_sorted]
        heavy_obs = order[is_heavy_obs]
        heavy_seg = np.searchsorted(heavy_pt_ids, pi_sorted[is_heavy_obs])
        # camera-sort so the camera-side reduction of the matrix-free term
        # runs over sorted keys (the point-side one is unsorted, it is tiny)
        csort = np.argsort(ci[heavy_obs], kind="stable")
        heavy_obs, heavy_seg = heavy_obs[csort], heavy_seg[csort]
        oh = heavy_obs.shape[0]
        oh_pad = _round_up(oh, 256)
        pad_h = oh_pad - oh
        # padding repeats the last observation (keeps the camera keys sorted)
        # but points at the trash heavy segment n_heavy_pts, whose V_λ⁻¹
        # column is zeroed in the matvec — exact zero contribution
        heavy_obs = np.concatenate([heavy_obs, np.full(pad_h, heavy_obs[-1], np.int64)])
        heavy_seg = np.concatenate([heavy_seg, np.full(pad_h, n_heavy_pts, np.int64)])
        heavy_cam = ci[heavy_obs]
        n_heavy_obs = oh
    else:
        heavy_obs = np.zeros(0, np.int64)
        heavy_seg = np.zeros(0, np.int64)
        heavy_cam = np.zeros(0, np.int64)
        n_heavy_obs = 0

    light_dmax = int(deg[~heavy_mask].max()) if (~heavy_mask).any() else 0
    chunks_i, chunks_j, chunks_p = [], [], []
    for d in range(1, light_dmax + 1):
        pts = np.nonzero(deg == d)[0]
        if pts.size == 0:
            continue
        base = starts[pts]                                   # (n_d,)
        obsmat = order[base[:, None] + np.arange(d)[None, :]]  # (n_d, d)
        if symmetric:
            # unordered pairs incl. the diagonal; orient so ci(ii) ≤ ci(jj)
            # (each (camera, point) is observed at most once, so a ≠ b ⇒
            #  distinct cameras)
            iu, ju = np.triu_indices(d)
            oa = obsmat[:, iu].reshape(-1)
            ob = obsmat[:, ju].reshape(-1)
            swap = ci[oa] > ci[ob]
            ii = np.where(swap, ob, oa)
            jj = np.where(swap, oa, ob)
            pp = np.broadcast_to(pts[:, None],
                                 (pts.size, iu.size)).reshape(-1)
        else:
            ii = np.broadcast_to(obsmat[:, :, None], (pts.size, d, d)).reshape(-1)
            jj = np.broadcast_to(obsmat[:, None, :], (pts.size, d, d)).reshape(-1)
            pp = np.broadcast_to(pts[:, None, None], (pts.size, d, d)).reshape(-1)
        chunks_i.append(ii)
        chunks_j.append(jj)
        chunks_p.append(pp)

    pair_i = np.concatenate(chunks_i) if chunks_i else np.zeros(0, np.int64)
    pair_j = np.concatenate(chunks_j) if chunks_j else np.zeros(0, np.int64)
    pair_p = np.concatenate(chunks_p) if chunks_p else np.zeros(0, np.int64)
    np_real = pair_i.shape[0]

    use_banded = bool(symmetric and banded
                      and (np_real or trk_mask is not None
                           or slot_buckets is not None))
    # band-coverage admission runs unless track/slot layouts already cover
    # most observations (their structure is in-band by construction)
    if use_banded and np_real and covered_obs < 0.5 * max(n_obs, 1):
        # band-coverage admission (VERDICT r4 missing #1): community-photo
        # covisibility has ~C distinct index offsets, so the ≤32-offset band
        # would catch almost no pairs and push everything through the slow
        # off-band gather path while paying for a useless band grid. Band
        # only when the capped band would cover most pairs.
        # coverage counts OFF-DIAGONAL pairs only: the diagonal (offset 0,
        # ~2/(d+1) of all pairs) is stored either way and would otherwise
        # mask a useless band (a plan whose band is only the diagonal)
        off_all = ci[pair_j] - ci[pair_i]
        off_nz = off_all[off_all > 0]
        _, cnt_all = np.unique(off_nz, return_counts=True)
        top32 = np.sort(cnt_all)[::-1][:32].sum()
        if off_nz.size and top32 < 0.5 * off_nz.size:
            use_banded = False
            if trk_mask is not None or slot_buckets is not None:
                # partially-engaged layouts need the band grid; without it
                # their points must go back to pair enumeration
                return build_pair_plan(
                    cam_idx, pt_idx, n_obs, n_cameras, n_points,
                    max_degree=max_degree, pad_multiple=pad_multiple,
                    symmetric=symmetric, banded=False, tracks=False,
                    slots=False)
    band_list: tuple = ()
    c_pad = k_band = 0
    if use_banded:
        # band selection: include EVERY populated offset cj−ci when there are
        # ≤ 32 of them — real covisibility graphs (trajectory window + a few
        # loop-closure wraparound offsets) collapse to a handful, and a
        # FULLY banded plan (zero off-band segments) runs its whole CG
        # matvec without gathers. With > 32 offsets, keep
        # the 32 heaviest by pair count; the rest go through the generic
        # off-band gather path.
        cip = ci[pair_i]
        cjp = ci[pair_j]
        off = cjp - cip                                   # ≥ 0 (ci ≤ cj)
        u_off, n_pairs_per_off = np.unique(off, return_counts=True)
        # window offsets are mandatory band slots (the track/slot paths
        # write them); protect them through the 32-offset cap
        protect = max(trk_dmax,
                      slot_span_max + 1 if slot_buckets is not None else 0)
        if protect:
            extra = np.setdiff1d(np.arange(protect), u_off)
            u_off = np.concatenate([u_off, extra])
            n_pairs_per_off = np.concatenate(
                [n_pairs_per_off.astype(np.int64),
                 np.full(extra.shape, 1 << 60, np.int64)])
            srt = np.argsort(u_off)
            u_off, n_pairs_per_off = u_off[srt], n_pairs_per_off[srt]
            win = u_off < protect
            n_pairs_per_off = np.where(win, 1 << 60, n_pairs_per_off)
        band_mask = np.ones(u_off.shape[0], bool)
        if u_off.shape[0] > 32:                           # cap band width
            order_cnt = np.argsort(-n_pairs_per_off)
            keep = set(u_off[order_cnt[:32]].tolist()) | {0}
            band_mask = np.array([o in keep for o in u_off])
        band_arr = u_off[band_mask]
        if 0 not in band_arr:
            band_arr = np.concatenate([[0], band_arr])
        band_list = tuple(int(o) for o in band_arr)
        # +trk_dmax margin: the track reduction keys are start+a ≤
        # (C−1)+(dmax−1) and must stay inside one band row
        c_pad = _round_up(n_cameras + trk_dmax, 128)
        k_band = len(band_list) * c_pad

        off_to_idx = np.full(int(u_off.max()) + 1, -1, np.int64)
        off_to_idx[band_arr] = np.arange(len(band_list))
        oi = off_to_idx[off]
        in_band = oi >= 0
        seg_real = np.empty(np_real, np.int64)
        seg_real[in_band] = oi[in_band] * c_pad + cip[in_band]
        left_key = cip[~in_band] * n_cameras + cjp[~in_band]
        u_left = np.unique(left_key)
        K_left = int(u_left.shape[0])
        seg_real[~in_band] = k_band + np.searchsorted(u_left, left_key)
        K = k_band + K_left
        k_pad = _round_up(K + 1, pad_multiple)

        perm = np.argsort(seg_real, kind="stable")
        pair_i, pair_j, pair_p = pair_i[perm], pair_j[perm], pair_p[perm]
        seg_real = seg_real[perm]
        key = ci[pair_i] * n_cameras + ci[pair_j]

        np_pad = _round_up(max(np_real, 1), pad_multiple)
        pad = np_pad - np_real
        fill_obs = max(n_obs - 1, 0)
        pair_i = np.concatenate([pair_i, np.full(pad, fill_obs, np.int64)])
        pair_j = np.concatenate([pair_j, np.full(pad, fill_obs, np.int64)])
        pair_p = np.concatenate([pair_p, np.zeros(pad, np.int64)])
        key = np.concatenate([key, np.full(pad, n_cameras * n_cameras,
                                           np.int64)])
        pair_seg = np.concatenate([seg_real, np.full(pad, k_pad - 1,
                                                     np.int64)])

        # slot → camera-pair maps (band slots: absent ⇒ trash row C)
        seg_ci = np.full(k_pad, n_cameras, np.int64)
        seg_cj = np.zeros(k_pad, np.int64)
        slot_c = np.arange(k_band) % c_pad
        slot_off = np.asarray(band_list)[np.arange(k_band) // c_pad]
        slot_ok = (slot_c < n_cameras) & (slot_c + slot_off < n_cameras)
        seg_ci[:k_band] = np.where(slot_ok, slot_c, n_cameras)
        seg_cj[:k_band] = np.where(slot_ok, slot_c + slot_off, 0)
        seg_ci[k_band:K] = u_left // n_cameras
        seg_cj[k_band:K] = u_left % n_cameras
        diag_pos = np.arange(n_cameras)                   # slot (0, c) = c
    else:
        key = ci[pair_i] * n_cameras + ci[pair_j]
        perm = np.argsort(key, kind="stable")
        pair_i, pair_j, pair_p, key = (
            pair_i[perm], pair_j[perm], pair_p[perm], key[perm])

        np_pad = _round_up(max(np_real, 1), pad_multiple)
        pad = np_pad - np_real
        fill_obs = max(n_obs - 1, 0)
        pair_i = np.concatenate([pair_i, np.full(pad, fill_obs, np.int64)])
        pair_j = np.concatenate([pair_j, np.full(pad, fill_obs, np.int64)])
        pair_p = np.concatenate([pair_p, np.zeros(pad, np.int64)])
        key = np.concatenate([key, np.full(pad, n_cameras * n_cameras, np.int64)])

        # compact covisibility segments: rank the K distinct real keys; padding
        # pairs land in the trash segment k_pad−1 (zeroed after the reduction)
        uniq, inv = np.unique(key[:np_real], return_inverse=True)
        K = int(uniq.shape[0])
        k_pad = _round_up(K + 1, pad_multiple)
        pair_seg = np.concatenate([inv, np.full(pad, k_pad - 1, np.int64)])
        seg_ci = np.full(k_pad, n_cameras, np.int64)
        seg_cj = np.zeros(k_pad, np.int64)
        seg_ci[:K] = uniq // n_cameras
        seg_cj[:K] = uniq % n_cameras
        diag_pos = np.searchsorted(uniq, np.arange(n_cameras) * (n_cameras + 1))
        diag_pos = np.minimum(diag_pos, max(K - 1, 0))
        hit = uniq[diag_pos] == np.arange(n_cameras) * (n_cameras + 1) if K else \
            np.zeros(n_cameras, bool)
        diag_pos = np.where(hit, diag_pos, k_pad - 1)

    nondiag = None
    if symmetric and not use_banded:
        # transposed-pass mask: diagonal blocks are applied once
        nondiag = (seg_ci != seg_cj).astype(np.float32)

    track_layout = None
    if trk_mask is not None:
        from tpu_ba.solver.tracks import build_track_layout

        track_layout = build_track_layout(
            cam_idx, pt_idx, n_obs, n_cameras, n_points, c_pad)

    slot_layout = None
    if slot_buckets is not None and use_banded:
        from tpu_ba.solver.slots import finalize_slot_layout

        slot_layout = finalize_slot_layout(slot_buckets, band_list, c_pad)

    return PairPlan(
        track=track_layout,
        slot=slot_layout,
        pair_i=jnp.asarray(pair_i.astype(np.int32)),
        pair_j=jnp.asarray(pair_j.astype(np.int32)),
        pair_pt=jnp.asarray(pair_p.astype(np.int32)),
        pair_key=jnp.asarray(key.astype(np.int32)),
        pair_seg=jnp.asarray(pair_seg.astype(np.int32)),
        seg_ci=jnp.asarray(seg_ci.astype(np.int32)),
        seg_cj=jnp.asarray(seg_cj.astype(np.int32)),
        diag_pos=jnp.asarray(diag_pos.astype(np.int32)),
        heavy_obs=jnp.asarray(heavy_obs.astype(np.int32)),
        heavy_cam=jnp.asarray(heavy_cam.astype(np.int32)),
        heavy_seg=jnp.asarray(heavy_seg.astype(np.int32)),
        heavy_pt_ids=jnp.asarray(heavy_pt_ids.astype(np.int32)),
        n_pairs=int(np_pad),
        n_cameras=int(n_cameras),
        max_degree=int(dmax),
        n_segments=K,
        k_pad=int(k_pad),
        n_heavy_obs=n_heavy_obs,
        n_heavy_pts=n_heavy_pts,
        symmetric=bool(symmetric),
        nondiag=(jnp.asarray(nondiag) if nondiag is not None else None),
        banded=use_banded,
        band_offsets=band_list,
        c_pad=int(c_pad),
        k_band=int(k_band),
    )


class PairData(NamedTuple):
    """λ-free per-linearization gathers, reused across λ-retries.

    ``packed`` (2·3dc+9, Np) lane-major: rows 0..3dc-1 are W[pair_i], rows
    3dc..6dc-1 are W[pair_j], the last 9 rows are V[pair_pt].
    ``heavy_W`` (3dc, Oh) / ``heavy_V`` (9, Ph) carry the heavy-track side
    channel (None when every track fits max_degree)."""

    packed: jax.Array
    heavy_W: jax.Array | None = None
    heavy_V: jax.Array | None = None
    # track-major pack (tpu_ba/solver/tracks.py): W in (27, dmax, Pt) slot
    # order, V in start-sorted point order — ONE O-sized permutation gather
    # replacing the quadratic per-pair gather for consecutive tracks
    trk_W: jax.Array | None = None
    trk_V: jax.Array | None = None
    # slot-major pack (tpu_ba/solver/slots.py): degree-bucketed tuples of
    # (27, d, Pk) / (9, Pk) — same one-permutation idea for ARBITRARY short
    # tracks (the Venice windowed-with-dropouts structure)
    slot_W: tuple | None = None
    slot_V: tuple | None = None


def precompute_pair_data(B: BlockSystem, pairs: PairPlan,
                         W_override=None) -> PairData:
    """λ-free per-linearization gathers into pair order.

    The BlockSystem is already lane-major ((3dc,O) / (9,P)), so these are
    column gathers along the batch axis — no transposes.

    ``W_override`` supplies globally-indexed W blocks when B.W is an
    observation shard (the sharded path all-gathers W once per
    linearization; pair indices are global observation ids)."""
    W = B.W if W_override is None else W_override
    packed = jnp.concatenate(
        [W[:, pairs.pair_i], W[:, pairs.pair_j], B.V[:, pairs.pair_pt]],
        axis=0)
    trk_W = trk_V = None
    if pairs.track is not None:
        from tpu_ba.solver.tracks import gather_track_data

        trk_W, trk_V = gather_track_data(W, B.V, pairs.track)
    slot_W = slot_V = None
    if pairs.slot is not None:
        from tpu_ba.solver.slots import gather_slot_data

        slot_W, slot_V = gather_slot_data(W, B.V, pairs.slot)
        slot_W, slot_V = tuple(slot_W), tuple(slot_V)
    if pairs.n_heavy_pts == 0:
        return PairData(packed, trk_W=trk_W, trk_V=trk_V,
                        slot_W=slot_W, slot_V=slot_V)
    return PairData(packed, W[:, pairs.heavy_obs], B.V[:, pairs.heavy_pt_ids],
                    trk_W=trk_W, trk_V=trk_V, slot_W=slot_W, slot_V=slot_V)


def _heavy_operator(pair_data: PairData, lam, pairs: PairPlan, dc: int,
                    diag_floor, diag_ceil):
    """Matrix-free S-term for heavy tracks at damping λ.

    Returns (term, diag_h): ``term(x)`` (C,dc) → (C,dc) applies
    [W V_λ⁻¹ Wᵀ]_heavy, ``diag_h`` (C, dc, dc) is its exact camera block
    diagonal (for the block-Jacobi preconditioner). Both are exact-zero when
    padding rows are touched (the trash V_λ⁻¹ column is zeroed)."""
    from tpu_ba.solver.schur import (_matmul_rows_33, _w_dot, _wt_dot,
                                     w_vinv_wt_diag)

    Wh, Vh = pair_data.heavy_W, pair_data.heavy_V
    C = pairs.n_cameras
    Ph = pairs.n_heavy_pts

    dV = jnp.clip(jnp.stack([Vh[0], Vh[4], Vh[8]]), diag_floor, diag_ceil)
    Vl = Vh.at[0].add(lam * dV[0]).at[4].add(lam * dV[1]).at[8].add(lam * dV[2])
    Vinv = inv3x3_rows(Vl)                                # (9, Ph)
    Vinv = jnp.pad(Vinv, ((0, 0), (0, 1)))                # trash column = 0

    def term(x):
        xg = x.T[:, pairs.heavy_cam]                      # (dc, Oh)
        wtx = _wt_dot(Wh, xg, dc)                         # (3, Oh)
        t = jax.ops.segment_sum(wtx.T, pairs.heavy_seg, Ph + 1).T   # (3, Ph+1)
        u = _matmul_rows_33(Vinv, t)                      # (3, Ph+1)
        ug = u[:, pairs.heavy_seg]                        # (3, Oh)
        z = _w_dot(Wh, ug, dc)                            # (dc, Oh)
        return jax.ops.segment_sum(z.T, pairs.heavy_cam, C,
                                   indices_are_sorted=True)  # (C, dc)

    diag_h = w_vinv_wt_diag(Wh, Vinv, pairs.heavy_cam, pairs.heavy_seg, C)
    return term, diag_h


def _pair_products_t(packed_t, lam, dc: int, diag_floor, diag_ceil):
    """vals_t (dc², Np): per-pair blocks W_i V_λ⁻¹ W_jᵀ, all lane-major.

    The 3×3 damped inverses are recomputed per pair — ~60 FLOPs each —
    which keeps the λ-retry path 100% gather-free (SURVEY.md §7 hard part
    (a): static index maps, no dynamic addressing in the hot loop).
    """
    Wi = packed_t[0:3 * dc]                  # rows (i,a) → 3i+a
    Wj = packed_t[3 * dc:6 * dc]
    V = packed_t[6 * dc:6 * dc + 9]          # rows (a,b) → 3a+b

    dV = jnp.clip(jnp.stack([V[0], V[4], V[8]]), diag_floor, diag_ceil)
    Vl = V.at[0].add(lam * dV[0]).at[4].add(lam * dV[1]).at[8].add(lam * dV[2])
    Vinv = inv3x3_rows(Vl)                  # (9, Np)

    # M[3i+b] = Σ_a Wi[3i+a] · Vinv[3a+b]
    M = jnp.stack([
        sum(Wi[3 * i + a] * Vinv[3 * a + b] for a in range(3))
        for i in range(dc) for b in range(3)
    ])
    # vals[dc·i+j] = Σ_b M[3i+b] · Wj[3j+b]
    vals = jnp.stack([
        sum(M[3 * i + b] * Wj[3 * j + b] for b in range(3))
        for i in range(dc) for j in range(dc)
    ])
    return vals                               # (dc², Np)


def _reduce_pairs_t(vals_t, pair_key, n_cameras: int):
    """T_t (dc², C²): segment-sum of pair blocks by camera-pair key (sorted;
    the trailing trash segment C² collects padding). Stays lane-major."""
    C = n_cameras
    out = jax.ops.segment_sum(vals_t.T, pair_key, C * C + 1,
                              indices_are_sorted=True)
    return out.T[:, : C * C]


def build_schur_t(B: BlockSystem, lam, pairs: PairPlan, pair_data,
                  diag_floor: float, diag_ceil: float):
    """The reduced camera system in T-major layout.

    Returns (Ul, T4, diag_S):
      Ul     (C, dc, dc) — damped camera diagonal blocks
      T4     (dc, dc, C, C) — Σ_p W V_λ⁻¹ Wᵀ with the block dims leading
      diag_S (C, dc, dc) — exact block diagonal of S = U_λ − T
    The matvec never materializes S: y = Ul·x − einsum("ijcd,dj->ci", T4, x).
    """
    if pairs.symmetric:
        raise ValueError("build_schur_t needs a full (non-symmetric) pair "
                         "plan; build with symmetric=False")
    C = pairs.n_cameras
    dc = B.U.shape[-1]
    Ul, _ = damp_blocks(B, lam, diag_floor, diag_ceil)

    vals_t = _pair_products_t(pair_data.packed, lam, dc, diag_floor, diag_ceil)
    T_t = _reduce_pairs_t(vals_t, pairs.pair_key, C)            # (dc², C²)
    T4 = T_t.reshape(dc, dc, C, C)

    idx = jnp.arange(C)
    T_diag = T4[:, :, idx, idx].transpose(2, 0, 1)              # (C, dc, dc)
    diag_S = Ul - T_diag
    return Ul, T4, diag_S


def build_dense_schur(B: BlockSystem, lam, pairs: PairPlan, pair_data,
                      diag_floor: float, diag_ceil: float):
    """Materialize S = U_λ − W V_λ⁻¹ Wᵀ as (dc·C, dc·C) plus its exact block
    diagonal (C, dc, dc). Test/oracle entry point — the solver itself stays
    in T-major layout (build_schur_t) and never forms this matrix."""
    if pairs.n_heavy_pts:
        raise ValueError("build_dense_schur (test oracle) does not fold in "
                         "heavy tracks; build the plan with a larger "
                         "max_degree for matrix materialization")
    C = pairs.n_cameras
    dc = B.U.shape[-1]
    Ul, T4, diag_S = build_schur_t(B, lam, pairs, pair_data,
                                   diag_floor, diag_ceil)
    S4 = -T4.transpose(2, 0, 3, 1)                              # (C, dc, C, dc)
    idx = jnp.arange(C)
    S4 = S4.at[idx, :, idx, :].add(Ul)
    return S4.reshape(C * dc, C * dc), diag_S


def solve_schur_dense(B: BlockSystem, lam, pairs: PairPlan, pair_data=None, *,
                      cg_max_iters: int, cg_tol, cg_x0=None,
                      diag_floor: float, diag_ceil: float):
    """Full linear solve on the explicit dense reduced camera system.

    Returns (δ_cameras, δ_points, cg_iters, ok) — same contract as
    solve_schur_pcg (tpu_ba/solver/schur.py), verified equivalent in tests.
    ``ok`` is the PCG no-breakdown flag.
    """
    from tpu_ba.solver.pcg import pcg

    if pair_data is None:
        pair_data = precompute_pair_data(B, pairs)
    C = pairs.n_cameras
    dc = B.U.shape[-1]

    Ul, T4, diag_S = build_schur_t(B, lam, pairs, pair_data,
                                   diag_floor, diag_ceil)
    heavy_term = None
    if pairs.n_heavy_pts:
        heavy_term, diag_h = _heavy_operator(pair_data, lam, pairs, dc,
                                             diag_floor, diag_ceil)
        diag_S = diag_S - diag_h

    # point-space inverses for RHS + back-substitution (P-sized, cheap)
    _, Vl_pts = damp_blocks(B, lam, diag_floor, diag_ceil)
    Vinv_pts = inv3x3_rows(Vl_pts)

    b = schur_rhs(B, Vinv_pts)                                 # (C, dc)

    Minv = inv_spd_small(diag_S)

    def matvec(x):
        y = jnp.einsum("cij,cj->ci", Ul, x)
        y = y - jnp.einsum("ijcd,dj->ci", T4, x)
        if heavy_term is not None:
            y = y - heavy_term(x)
        return y

    def precond(r):
        return jnp.einsum("cij,cj->ci", Minv, r)

    dx_cam, cg_iters, ok = pcg(matvec, b, precond,
                               max_iters=cg_max_iters, tol=cg_tol, x0=cg_x0)
    dx_pt = back_substitute(B, Vinv_pts, dx_cam)
    return dx_cam, dx_pt, cg_iters, ok


def _compact_blocks(B: BlockSystem, lam, pairs: PairPlan, pair_data,
                    diag_floor: float, diag_ceil: float):
    """blk (dc², k_pad): the K nonzero (dc×dc) blocks of T = W V_λ⁻¹ Wᵀ in
    compact covisibility-segment order (blk[dc·i+j, k] = T_{seg_ci[k],
    seg_cj[k]}[i, j]); columns ≥ K are exact zeros. The reduction runs over
    *sorted compact* segment ids — K ≈ covisible pairs, not C²."""
    dc = B.U.shape[-1]
    vals_t = _pair_products_t(pair_data.packed, lam, dc, diag_floor, diag_ceil)
    blk = jax.ops.segment_sum(vals_t.T, pairs.pair_seg, pairs.k_pad,
                              indices_are_sorted=True).T
    # only the trash column k_pad−1 receives padding pairs (segment_sum
    # zero-initializes untouched segments) — zero it so diag_pos reads of
    # absent diagonals are exact zeros
    blk = blk.at[:, -1].set(0.0)

    if pairs.track is not None:
        # gather-free band contributions of the consecutive tracks: slot
        # pair (a, b) of a track starting at c0 is band block
        # (offset b−a, row c0+a) — added on top of the legacy pair rows
        from tpu_ba.solver import tracks as tracks_mod

        tl = pairs.track
        tout = tracks_mod.track_blocks_jnp(
            pair_data.trk_W, pair_data.trk_V, lam, tl, dc,
            diag_floor, diag_ceil)
        d2 = dc * dc
        cp = pairs.c_pad
        for g in range(tl.dmax):
            pos = pairs.band_offsets.index(g) * cp
            blk = blk.at[:, pos:pos + cp].add(tout[g * d2:(g + 1) * d2, :cp])

    if pairs.slot is not None:
        # slot-major band contributions (tpu_ba/solver/slots.py): level-1
        # bucket reductions + level-2 fold emit the off-major band grid
        # directly — same layout as blk[:, :k_band]
        from tpu_ba.solver.slots import slot_blocks_jnp

        sout = slot_blocks_jnp(
            pair_data.slot_W, pair_data.slot_V, lam, pairs.slot, dc,
            diag_floor, diag_ceil)
        blk = blk.at[:, :pairs.k_band].add(sout)
    return blk


def make_banded_matvec(blk, Ul, pairs: PairPlan, dc: int, heavy_term=None):
    """S·x for the banded-symmetric layout: NO gathers on the hot band.

    The band region of ``blk`` is a dense (offset, ci) grid (see
    build_pair_plan), so applying T = Σ W V_λ⁻¹ Wᵀ is static rolls + FMAs —
    the whole band streams once per matvec, replacing the two (dc, k_pad)
    gathers of the generic compact path. Off-band leftover segments (ring
    wraparound / loop closures; ~0.1% of pairs on trajectory problems) run
    the generic gather path on a tiny
    slice. Verified ≡ the non-symmetric compact oracle in tests/test_pairs.py.
    """
    C = pairs.n_cameras
    Bn = len(pairs.band_offsets)
    Cp = pairs.c_pad
    Sb = blk[:, :pairs.k_band].reshape(dc, dc, Bn, Cp)
    have_left = pairs.n_segments > pairs.k_band

    def matvec(x):
        y = jnp.einsum("cij,cj->ci", Ul, x)
        x_t = jnp.zeros((dc, Cp), x.dtype).at[:, :C].set(x.T)
        # forward: y_c −= Σ_off T_{c,c+off} x_{c+off}. roll(−off) aligns
        # x_{c+off} onto lane c; the wrap-contaminated lanes c ≥ Cp−off all
        # have zero band blocks (cj = c+off ≥ C has no segments).
        Xs = jnp.stack([jnp.roll(x_t, -off, axis=1)
                        for off in pairs.band_offsets])        # (B, dc, Cp)
        t = jnp.einsum("mnoc,onc->mc", Sb, Xs)
        # transposed: y_{c+off} −= T_{c,c+off}ᵀ x_c for off > 0.
        if Bn > 1:
            u = jnp.einsum("mnoc,mc->onc", Sb[:, :, 1:], x_t)  # (B−1, dc, Cp)
            for oi, off in enumerate(pairs.band_offsets[1:]):
                t = t + jnp.roll(u[oi], off, axis=1)
        y = y - t[:, :C].T
        if have_left:
            lblk = blk[:, pairs.k_band:]
            lci = pairs.seg_ci[pairs.k_band:]
            lcj = pairs.seg_cj[pairs.k_band:]
            xgl = x.T[:, lcj]                                  # (dc, L)
            zl = jnp.stack([
                sum(lblk[dc * m + n] * xgl[n] for n in range(dc))
                for m in range(dc)
            ])
            tl = jax.ops.segment_sum(zl.T, lci, C + 1,
                                     indices_are_sorted=True)   # (C+1, dc)
            xgl2 = x.T[:, jnp.minimum(lci, C - 1)]
            zl2 = jnp.stack([
                sum(lblk[dc * m + n] * xgl2[m] for m in range(dc))
                for n in range(dc)
            ])
            tl2 = jax.ops.segment_sum(zl2.T, lcj, C + 1)        # unsorted, tiny
            y = y - tl[:C] - tl2[:C]
        if heavy_term is not None:
            y = y - heavy_term(x)
        return y

    return matvec


def solve_schur_sparse(B: BlockSystem, lam, pairs: PairPlan, pair_data=None, *,
                       cg_max_iters: int, cg_tol, cg_x0=None,
                       diag_floor: float, diag_ceil: float, axis_name=None,
                       precond: str = "jacobi"):
    """Linear solve on the *block-sparse* explicit reduced camera system.

    Same contract as solve_schur_dense, but S's off-diagonal structure is
    kept as K compact covisibility blocks instead of a dense (dc,dc,C,C)
    tensor: the per-λ build reduces pairs into (dc², K) and the CG matvec is
    gather → per-segment block·vector → segment-sum by row camera (or, for
    a banded plan, static rolls over the band grid). For sparse
    covisibility (Ladybug-class: K ≪ C²) this cuts both the per-λ build and
    the per-CG-iteration memory traffic by ~C²/K.

    Sharded (``axis_name`` set): pairs arrive as per-device shards (the
    plan's pair axis is partitioned over the mesh — tpu_ba/sharding/), each
    device reduces its shard into the full compact segment space, and ONE
    ``psum`` of the (dc², k_pad) compact blocks per λ-retry replicates S.
    The CG loop then runs fully replicated with ZERO per-iteration
    communication — the scaling advantage over the matrix-free schur_pcg
    path, which psums twice per CG iteration."""
    from tpu_ba.solver.pcg import pcg

    if pair_data is None:
        pair_data = precompute_pair_data(B, pairs)
    C = pairs.n_cameras
    dc = B.U.shape[-1]

    blk = _compact_blocks(B, lam, pairs, pair_data, diag_floor, diag_ceil)
    if axis_name is not None:
        blk = jax.lax.psum(blk, axis_name)

    Ul, Vl_pts = damp_blocks(B, lam, diag_floor, diag_ceil)

    # banded layout: the diagonal IS band slot (offset 0, c) — a plain slice
    diag_T = blk[:, :C] if pairs.banded else blk[:, pairs.diag_pos]
    diag_S = Ul - diag_T.reshape(dc, dc, C).transpose(2, 0, 1)
    heavy_term = None
    if pairs.n_heavy_pts:
        heavy_term, diag_h = _heavy_operator(pair_data, lam, pairs, dc,
                                             diag_floor, diag_ceil)
        diag_S = diag_S - diag_h
    Minv = inv_spd_small(diag_S)

    # block-tridiagonal PCR preconditioner (tpu_ba/solver/tridiag.py):
    # exact inverse of the {0, 1}-offset part of S, factored ONCE per
    # λ-retry; applied inside the PCG loop as O(log C) batched block-matvecs.
    pcr = None
    if (precond == "tridiag" and pairs.banded and pairs.n_heavy_pts == 0
            and len(pairs.band_offsets) > 1 and pairs.band_offsets[1] == 1):
        from tpu_ba.solver.tridiag import pcr_factor, tridiag_from_band

        D_t, B_up = tridiag_from_band(blk, diag_S, pairs, dc)
        pcr = pcr_factor(D_t, B_up)

    Vinv_pts = inv3x3_rows(Vl_pts)
    b = schur_rhs(B, Vinv_pts, axis_name)                      # (C, dc)

    if pairs.banded:
        matvec = make_banded_matvec(blk, Ul, pairs, dc, heavy_term)
    else:
        def matvec(x):
            y = jnp.einsum("cij,cj->ci", Ul, x)
            xg = x.T[:, pairs.seg_cj]                          # (dc, k_pad)
            z = jnp.stack([
                sum(blk[dc * i + j] * xg[j] for j in range(dc))
                for i in range(dc)
            ])                                                 # (dc, k_pad)
            t = jax.ops.segment_sum(z.T, pairs.seg_ci, C + 1,
                                    indices_are_sorted=True).T
            y = y - t[:, :C].T
            if pairs.symmetric:
                # transposed pass: y_cj −= T_{ci,cj}ᵀ x_ci for off-diag blocks
                # (padding segments: blk columns are exact zeros)
                xg2 = x.T[:, jnp.minimum(pairs.seg_ci, C - 1)]  # (dc, k_pad)
                z2 = jnp.stack([
                    sum(blk[dc * j + i] * xg2[j] for j in range(dc))
                    for i in range(dc)
                ]) * pairs.nondiag[None, :]
                t2 = jax.ops.segment_sum(z2.T, pairs.seg_cj, C + 1).T
                y = y - t2[:, :C].T
            if heavy_term is not None:
                y = y - heavy_term(x)
            return y

    if pcr is not None:
        from tpu_ba.solver.tridiag import pcr_apply

        def precond(r):
            return pcr_apply(*pcr, r)
    else:
        def precond(r):
            return jnp.einsum("cij,cj->ci", Minv, r)

    dx_cam, cg_iters, ok = pcg(matvec, b, precond,
                               max_iters=cg_max_iters, tol=cg_tol, x0=cg_x0)
    dx_pt = back_substitute(B, Vinv_pts, dx_cam, axis_name)
    return dx_cam, dx_pt, cg_iters, ok

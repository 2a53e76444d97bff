"""Photon mapping: wavefront photon tracing + fixed-radius hashed-grid
irradiance gather.

Replaces the reference's Jensen kd-tree photon map (PhotonMap.{h,cpp})
and recursive photon tracer (Scene::tracePhotons/traceCausticPhotons/
tracePhoton, Scene.cpp:351-655):

*Tracing* (exact reference semantics):
- only DirectionalAreaLights emit (dynamic_cast gate Scene.cpp:368,430);
  photon power = color * wattage * pi * r^2 (caustic: /10,
  Scene.cpp:380-385, 442-447); origin on the light disc, direction =
  light normal (parallel beam).
- per bounce: Russian roulette over [diffuse | reflect | refract |
  absorb] with cumulative probabilities avg(texColor), +avg(ks),
  +avg(kt) (Scene.cpp:544-562).
- diffuse: store only indirect photons (depth > 1, Scene.cpp:570), then
  continue with a cosine-weighted ray carrying texColor*power/p_d
  (Scene.cpp:604-608). Caustic photons whose FIRST bounce is diffuse
  die unstored (Scene.cpp:596-599).
- reflect/refract keep full power; refraction does a Fresnel Russian
  roulette (Scene.cpp:634-648). GLOBAL photons whose first bounce is
  specular die (Scene.cpp:612-614,626-628 — those paths belong to the
  caustic map).
- depth limit TRACE_DEPTH_PHOTONS = 5 (Miro.h:14).
- the reference's OpenMP criticals around kd-tree store disappear:
  stores are masked scatter-appends, race-free by construction.

*Gather*: instead of the kd-tree 500-NN search with unbounded radius
(PhotonMap.cpp:152-243, irradiance = sum P/(pi r_k^2) over the k
nearest, accepting photons with dir.normal < 0), photons are hashed
into a uniform grid with cell size = gather radius; the irradiance
estimate is a 27-cell fixed-radius sum  sum P / (pi r^2). The radius is
auto-tuned at build time so the average disc holds ~PHOTON_SAMPLES
photons, making the two estimators agree in expectation. Differentiable
w.r.t. photon powers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cse168_raytracer.core.fastgather import take_rows
from cse168_raytracer.config import EPSILON, PI, RenderConfig
from cse168_raytracer.core.sampling import cosine_hemisphere
from cse168_raytracer.core.vecmath import (fresnel_rs, reflect, refract,
                                           safe_normalize)
from cse168_raytracer.models.lights import LIGHT_DIRECTIONAL_AREA
from cse168_raytracer.models.scene import Scene, SceneStatic
from cse168_raytracer.models.textures import diffuse_color
from cse168_raytracer.ops.shading import trace_closest
from cse168_raytracer.utils import pytree

_H1, _H2, _H3 = 73856093, 19349663, 83492791  # classic spatial-hash primes


@pytree.dataclass
class PhotonGrid:
    """One photon map as a hashed uniform grid (CSR by sorted hash)."""
    pos: jax.Array          # (P, 3) photon positions (sorted by hash)
    power: jax.Array        # (P, 3) photon powers (pre-scaled)
    dir: jax.Array          # (P, 3) incoming directions
    weight: jax.Array       # (P,) photons represented (1 + folded share)
    cell_hash: jax.Array    # (P,) i32 sorted hash per photon
    radius: jax.Array       # () gather radius (= cell size)
    n_valid: jax.Array      # () i32
    table_size: int = pytree.static_field(default=1 << 20)
    max_per_cell: int = pytree.static_field(default=64)
    knn: int = pytree.static_field(default=500)
    # optional second level with cell size coarse_factor * radius: the
    # sparse-region fallback (see grid_irradiance). None on the coarse
    # level itself.
    coarse: Optional["PhotonGrid"] = None


@pytree.dataclass
class PhotonMaps:
    global_map: Optional[PhotonGrid]
    caustic_map: Optional[PhotonGrid]


def _hash_cells(cells: jax.Array, table_size: int) -> jax.Array:
    ix = cells[..., 0].astype(jnp.uint32) * np.uint32(_H1)
    iy = cells[..., 1].astype(jnp.uint32) * np.uint32(_H2)
    iz = cells[..., 2].astype(jnp.uint32) * np.uint32(_H3)
    return ((ix ^ iy ^ iz) % np.uint32(table_size)).astype(jnp.int32)


def build_grid(pos: np.ndarray, power: np.ndarray, dirs: np.ndarray,
               radius: float, max_per_cell: int = 64,
               knn: int = 500,
               coarse_factor: Optional[float] = 8.0) -> PhotonGrid:
    """Host-side grid build: hash, sort, upload.

    coarse_factor builds a SECOND grid over the same photons with cell
    size coarse_factor * radius — the sparse-region fallback for the
    k-NN gather: the reference's kd-tree search radius is UNBOUNDED
    (PHOTON_MAX_DIST = 1e10, Miro.h:16; PhotonMap.cpp:63-81), while a
    hashed grid can only see its 27-cell neighborhood, so where fewer
    than knn photons lie within `radius` the gather re-runs against the
    coarse level (radius bounded by coarse_factor * radius instead).

    Cells holding more than max_per_cell photons (caustic hotspots are
    exactly where that happens) get the OVERFLOW photons' power folded
    into the kept ones instead of silently dropped: total stored energy
    is preserved exactly, at the cost of a position/direction error
    bounded by the cell size (= gather radius). The gather
    (grid_irradiance) only ever visits the first max_per_cell photons
    of a run, so without this merge dense cells lose energy."""
    n = pos.shape[0]
    table_size = max(1 << int(np.ceil(np.log2(max(4 * n, 16)))), 16)
    cells = np.floor(pos / radius).astype(np.int64)
    h = ((cells[:, 0].astype(np.uint32) * np.uint32(_H1))
         ^ (cells[:, 1].astype(np.uint32) * np.uint32(_H2))
         ^ (cells[:, 2].astype(np.uint32) * np.uint32(_H3))) % table_size
    order = np.argsort(h, kind="stable")
    pos_s = pos[order].astype(np.float64)
    pow_s = power[order].astype(np.float64)
    dir_s = dirs[order].astype(np.float64)
    h_s = h[order]

    wgt = np.ones(n, np.float64)
    if n:
        starts = np.flatnonzero(np.r_[True, h_s[1:] != h_s[:-1]])
        counts = np.diff(np.r_[starts, n])
        rng = np.random.RandomState(0xC5E168)
        for s, c in zip(starts[counts > max_per_cell],
                        counts[counts > max_per_cell]):
            # over-full cell: keep an UNBIASED RANDOM SAMPLE of its
            # photons (not the first max_per_cell by hash order — that
            # erases intra-cell density structure, which the adaptive
            # k-NN radius search in grid_irradiance depends on), carry
            # the cell's EXACT total power on the kept reps (rescaled
            # proportionally), and give each rep weight c/cap so the
            # k search still counts true photon numbers.
            m = max_per_cell
            sel = s + np.sort(rng.choice(c, m, replace=False))
            tot = pow_s[s:s + c].sum(axis=0)
            pos_k = pos_s[sel].copy()
            pow_k = pow_s[sel].copy()
            dir_k = dir_s[sel].copy()
            ssum = pow_k.sum(axis=0)
            for ch in range(3):
                if ssum[ch] > 0:
                    pow_k[:, ch] *= tot[ch] / ssum[ch]
                elif tot[ch] != 0:
                    pow_k[:, ch] = tot[ch] / m
            pos_s[s:s + m] = pos_k
            pow_s[s:s + m] = pow_k
            dir_s[s:s + m] = dir_k
            pow_s[s + m:s + c] = 0.0   # beyond the gather cap: unreachable
            wgt[s:s + m] = c / m
            wgt[s + m:s + c] = 0.0

    coarse = None
    if coarse_factor is not None:
        coarse = build_grid(pos, power, dirs, radius * coarse_factor,
                            max_per_cell=max_per_cell, knn=knn,
                            coarse_factor=None)
    return PhotonGrid(
        pos=jnp.asarray(pos_s, jnp.float32),
        power=jnp.asarray(pow_s, jnp.float32),
        dir=jnp.asarray(dir_s, jnp.float32),
        weight=jnp.asarray(wgt, jnp.float32),
        cell_hash=jnp.asarray(h_s.astype(np.int32)),
        radius=jnp.float32(radius),
        n_valid=jnp.int32(n),
        table_size=int(table_size),
        max_per_cell=max_per_cell,
        knn=knn,
        coarse=coarse)


def grid_irradiance(grid: PhotonGrid, p: jax.Array, n: jax.Array,
                    chunk: int = 8192) -> jax.Array:
    """Fixed-radius irradiance estimate at points p with normals n.

    For each of the 27 neighbor cells: locate the photon run via
    searchsorted on the sorted hash array, gather up to max_per_cell
    photons, accept those within `radius` whose direction opposes the
    normal (PhotonMap.cpp:186), and sum power / (pi r^2).

    Wavefronts larger than `chunk` are processed in lax.map slices: the
    candidate gather materializes (N, 27, max_per_cell, 3) intermediates
    (~85 MB per 8192 points at the default cap), so a 262k-lane
    wavefront would transiently need gigabytes unchunked. Differentiable
    w.r.t. photon powers either way (lax.map is AD-transparent).
    """
    nn = p.shape[0]
    if nn > chunk:
        n_ch = -(-nn // chunk)
        n_pad = n_ch * chunk
        pp = jnp.concatenate([p, jnp.zeros((n_pad - nn, 3), p.dtype)])
        np_ = jnp.concatenate([n, jnp.ones((n_pad - nn, 3), n.dtype)])
        out = jax.lax.map(
            lambda args: grid_irradiance(grid, args[0], args[1], chunk),
            (pp.reshape(n_ch, chunk, 3), np_.reshape(n_ch, chunk, 3)))
        return out.reshape(n_pad, 3)[:nn]
    irr, cnt = _gather_level(grid, _pack_rows(grid), p, n)
    if grid.coarse is not None:
        # sparse-region fallback: where the fine level holds fewer than
        # knn photons within its radius, the k-NN search is radius-
        # LIMITED (the reference's kd-tree search is unbounded,
        # Miro.h:16) — re-gather against the coarse level, whose
        # 27-cell neighborhood spans coarse_factor * radius. The
        # coarse estimate is used only where it actually REACHES knn:
        # when even the coarse level is under-full, Jensen's estimator
        # divides by the (untightened) initial search radius and
        # returns ~0 (PhotonMap.cpp:81-141 with maxdist = 1e10), so
        # the fine fixed-radius estimate is the closer analog.
        irr_c, cnt_c = _gather_level(grid.coarse, _pack_rows(grid.coarse),
                                     p, n)
        use_c = (cnt < grid.knn) & (cnt_c >= grid.knn)
        irr = jnp.where(use_c[:, None], irr_c, irr)
    return irr


def _pack_rows(grid: PhotonGrid) -> jax.Array:
    """(P, 12) gather table [pos | power | dir | weight | pad]: a
    random-row gather pays per ROW, so _gather_level fetches ONE packed
    row per candidate instead of four narrow ones. Built ON-DEVICE from
    the live fields so d(irradiance)/d(stored power) flows (the
    photon-power gradient surface BASELINE.json names; a build-time-
    baked table silently detached it). The optimization barrier keeps
    XLA from fusing the concat INTO the gather (which would redo the
    concat per gathered row)."""
    P = grid.pos.shape[0]
    packed = jnp.concatenate([
        grid.pos, grid.power, grid.dir, grid.weight[:, None],
        jnp.zeros((P, 2), grid.pos.dtype)], axis=1)
    return jax.lax.optimization_barrier(packed)


def _gather_level(grid: PhotonGrid, packed: jax.Array, p: jax.Array,
                  n: jax.Array):
    """One grid level's density-adaptive gather. Returns
    (irradiance (N, 3), weighted photon count within the level radius
    (N,))."""
    r = grid.radius
    base = jnp.floor(p / r).astype(jnp.int32)          # (N, 3)
    offs = jnp.asarray(np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1],
                                            [-1, 0, 1], indexing="ij"),
                                axis=-1).reshape(27, 3).astype(np.int32))
    cells = base[:, None, :] + offs[None, :, :]        # (N, 27, 3)
    h = _hash_cells(cells, grid.table_size)            # (N, 27)
    # distinct neighbor cells can hash to the SAME bucket; probing a
    # bucket twice would double-count its photon run (the distance test
    # cannot tell). Sort the 27 probes and keep one per bucket.
    h = jnp.sort(h, axis=1)
    uniq = jnp.concatenate([jnp.ones_like(h[:, :1], bool),
                            h[:, 1:] != h[:, :-1]], axis=1)

    start = jnp.searchsorted(grid.cell_hash, h, side="left")   # (N, 27)
    end = jnp.searchsorted(grid.cell_hash, h, side="right")
    count = jnp.where(uniq,
                      jnp.minimum(end - start, grid.max_per_cell), 0)

    k = jnp.arange(grid.max_per_cell)                  # (K,)
    idx = start[..., None] + k                         # (N, 27, K)
    valid = (k < count[..., None]) & (idx < grid.n_valid)
    idx = jnp.clip(idx, 0, grid.pos.shape[0] - 1)

    g = packed[idx]                                    # (N, 27, K, 12)
    ppos = g[..., 0:3]
    ppow = g[..., 3:6]
    pdir = g[..., 6:9]
    pwgt = g[..., 9]                                   # (N, 27, K)

    d = ppos - p[:, None, None, :]
    d2 = jnp.sum(d * d, axis=-1)
    facing = jnp.sum(pdir * n[:, None, None, :], axis=-1) < 0.0
    in_r = valid & (d2 < r * r)

    # DENSITY-ADAPTIVE radius (Jensen's k-NN estimate,
    # PhotonMap.cpp:152-243): shrink the gather disc until it holds
    # ~knn photons, by 12-step bisection on r'^2 over the candidate
    # weights (fold weights stand in for the photon COUNT in capped
    # cells). The k-NN SEARCH is distance-only; the facing filter
    # applies to the SUM (PhotonMap.cpp:186). Where fewer than knn
    # photons lie within r, hi stays at r^2 — the fixed-radius estimate
    # — and the caller falls back to the coarse level (see
    # grid_irradiance). r' is a discrete-ish quantity: detached, like
    # the hit selection it parallels.
    k = jnp.float32(grid.knn)
    d2s = jax.lax.stop_gradient(d2)
    wts = jnp.where(jax.lax.stop_gradient(in_r), pwgt, 0.0)
    cnt_r = jnp.sum(wts, axis=(1, 2))                  # (N,)
    lo = jnp.zeros((p.shape[0],), jnp.float32)
    hi = jnp.full((p.shape[0],), r * r, jnp.float32)
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        cnt = jnp.sum(jnp.where(d2s < mid[:, None, None], wts, 0.0),
                      axis=(1, 2))
        ge = cnt >= k
        hi = jnp.where(ge, mid, hi)
        lo = jnp.where(ge, lo, mid)
    r2 = jax.lax.stop_gradient(hi)

    accept = in_r & (d2 < r2[:, None, None]) & facing
    total = jnp.sum(jnp.where(accept[..., None], ppow, 0.0), axis=(1, 2))
    return total / (PI * r2[:, None]), cnt_r


def irradiance_estimate(maps: PhotonMaps, p: jax.Array,
                        n: jax.Array) -> jax.Array:
    """Global + caustic irradiance (Scene.cpp:294-298)."""
    n_unit = safe_normalize(n)
    out = jnp.zeros_like(p)
    if maps.global_map is not None:
        out = out + grid_irradiance(maps.global_map, p, n_unit)
    if maps.caustic_map is not None:
        out = out + grid_irradiance(maps.caustic_map, p, n_unit)
    return out


# ---------------------------------------------------------------------------
# Photon tracing (wavefront)
# ---------------------------------------------------------------------------

class _StoredBatch(NamedTuple):
    pos: jax.Array     # (L, N, 3) per-level stored photon positions
    dir: jax.Array     # (L, N, 3)
    power: jax.Array   # (L, N, 3)
    mask: jax.Array    # (L, N) bool
    bounces: jax.Array  # (L,) i32 photons alive+hitting at each level
    #                     (the -DSTATS photon-bounce counter, Stats.h)


def trace_photon_batch(scene: Scene, static: SceneStatic, light_i: int,
                       n_emit: int, caustic: bool, depth_limit: int,
                       path_tracing: bool, key: jax.Array) -> _StoredBatch:
    """Emit and trace n_emit photons from light light_i. Returns the
    per-level stored-photon arrays (masked). Jit-friendly."""
    from cse168_raytracer.models.lights import (sample_origin,
                                                sample_photon_direction)
    from cse168_raytracer.core.sampling import phong_lobe

    lt = scene.lights
    mats = scene.materials
    k_o, k_d, k_loop = jax.random.split(key, 3)
    pos = sample_origin(lt, light_i, k_o, (n_emit,))
    dirs = sample_photon_direction(lt, light_i, k_d, (n_emit,))
    # power = color * wattage * pi * r^2 (/10 caustic), Scene.cpp:380-385
    p0 = lt.color[light_i] * lt.wattage[light_i]
    is_dir_light = lt.kind[light_i] == LIGHT_DIRECTIONAL_AREA
    area = PI * lt.radius[light_i] ** 2
    p0 = jnp.where(is_dir_light, p0 * area / (10.0 if caustic else 1.0), p0)
    power = jnp.broadcast_to(p0, (n_emit, 3))
    alive = jnp.ones((n_emit,), bool)

    levels = []
    for level in range(depth_limit + 1):
        lk = jax.random.fold_in(k_loop, level)
        k_rr, k_cos, k_fres, k_lobe = jax.random.split(lk, 4)
        depth_after = level + 1

        o = pos + EPSILON * dirs                        # Scene.cpp:535
        hit, surf = trace_closest(scene, static, o, dirs)
        live = alive & hit.hit

        mid = surf.material_id
        tex = diffuse_color(mats, scene.images, mid, surf.uv, surf.p,
                            static.texture_kinds)
        p_diff = jnp.mean(tex, axis=-1)                 # average()
        p_refl = p_diff + jnp.mean(take_rows(mats.ks, mid), axis=-1)
        p_refr = p_refl + jnp.mean(take_rows(mats.kt, mid), axis=-1)
        rnd = jax.random.uniform(k_rr, (n_emit,))

        take_diff = live & (rnd < p_diff)
        take_refl = live & (rnd >= p_diff) & (rnd < p_refl)
        take_refr = live & (rnd >= p_refl) & (rnd < p_refr)
        # rnd > p_refr: absorbed

        # --- store (diffuse, indirect only) ---
        store = take_diff & (depth_after > 1)
        levels.append((surf.p, dirs, power, store,
                       jnp.sum(live.astype(jnp.int32))))

        # --- first-bounce gates (Scene.cpp:596-628) ---
        if depth_after == 1:
            if caustic:
                take_diff = jnp.zeros_like(take_diff)    # die unstored
            else:
                take_refl = jnp.zeros_like(take_refl)    # caustic-only paths
                take_refr = jnp.zeros_like(take_refr)

        # --- continuations ---
        n_unit = safe_normalize(surf.n)
        cos_d, _ = cosine_hemisphere(k_cos, n_unit)
        diff_power = tex * power / jnp.maximum(p_diff, 1e-12)[:, None]

        mirror = safe_normalize(reflect(dirs, n_unit))
        ior = take_rows(mats.ior, mid)
        rs = fresnel_rs(dirs, n_unit, ior)
        refr_d, _ = refract(dirs, n_unit, ior)
        refr_d = safe_normalize(refr_d)
        if path_tracing:
            shin = take_rows(mats.shininess, mid)
            mirror, _ = phong_lobe(k_lobe, mirror, shin)
            refr_d, _ = phong_lobe(jax.random.fold_in(k_lobe, 1),
                                   refr_d, shin)
        fres_reflect = jax.random.uniform(k_fres, (n_emit,)) < rs
        refr_dir = jnp.where(fres_reflect[:, None], mirror, refr_d)

        new_dir = jnp.where(take_diff[:, None], cos_d,
                            jnp.where(take_refl[:, None], mirror, refr_dir))
        new_power = jnp.where(take_diff[:, None], diff_power, power)
        alive = take_diff | take_refl | take_refr
        pos = surf.p
        dirs = jnp.where(alive[:, None], new_dir,
                         jnp.array([0.0, 0.0, 1.0]))
        power = new_power

    return _StoredBatch(
        pos=jnp.stack([l[0] for l in levels]),
        dir=jnp.stack([l[1] for l in levels]),
        power=jnp.stack([l[2] for l in levels]),
        mask=jnp.stack([l[3] for l in levels]),
        bounces=jnp.stack([l[4] for l in levels]))


def trace_photon_batch_sharded(scene: Scene, static: SceneStatic,
                               light_i: int, n_emit: int, caustic: bool,
                               depth_limit: int, path_tracing: bool,
                               key: jax.Array, mesh) -> _StoredBatch:
    """Photon emission sharded over a device mesh — the multi-device
    form of the reference's OpenMP photon batches (Scene.cpp:372-394): each
    device traces n_emit/n_dev photons with a device-unique key; the
    per-level stored-photon arrays come back sharded on the photon axis
    (no collective needed in the forward pass; the host concatenates).
    """
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    axis = mesh.axis_names[0]
    n_dev = mesh.size
    per = -(-n_emit // n_dev)

    def emit(scene, key):
        ti = jax.lax.axis_index(axis)
        out = trace_photon_batch(scene, static, light_i, per, caustic,
                                 depth_limit, path_tracing,
                                 jax.random.fold_in(key, ti))
        # bounce counters all-reduce across the mesh (replicated out)
        return out._replace(bounces=jax.lax.psum(out.bounces, axis))

    out_specs = _StoredBatch(pos=P(None, axis, None),
                             dir=P(None, axis, None),
                             power=P(None, axis, None),
                             mask=P(None, axis),
                             bounces=P())
    # check_vma=False for the same documented reason as
    # parallel/sharding.py: the checker demands pvary on scan-carry
    # constants inside trace_photon_batch, which also runs unsharded
    fn = shard_map(emit, mesh=mesh, in_specs=(P(), P()),
                   out_specs=out_specs, check_vma=False)
    return fn(scene, key)


def _auto_radius(pos: np.ndarray, k_target: int, max_per_cell: int) -> float:
    """Pick the gather radius so a typical r-disc holds about k_target
    photons — the reference's k-NN estimate (k = PHOTON_SAMPLES = 500,
    Miro.h:17) expressed as a fixed radius.

    The per-cell gather cap (max_per_cell) does NOT bound k here: cells
    past the cap have their overflow power folded into the kept photons
    at build time (build_grid), so the full ~k_target energy is always
    reachable — the cap only quantizes folded photons' positions to
    their cell (error < r*sqrt(3)). test_photon's clustered oracle pins
    the resulting estimate against a true brute-force k-NN estimate.

    Method: subsample m photons, take each one's distance to its
    ceil(k*m/n)-th nearest neighbor within the subsample (density
    scales linearly, so the k'th-NN radius in an m-subsample matches
    the (k*n/m)'th-NN radius in the full set), and use the median."""
    n = pos.shape[0]
    if n < 8:
        return 1.0
    k_eff = int(k_target)
    m = int(min(n, 4000))
    rng = np.random.RandomState(0)
    sub = pos[rng.choice(n, m, replace=False)].astype(np.float64)
    k_sub = max(1, int(round(k_eff * m / n)))
    k_sub = min(k_sub, m - 1)
    d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    kth = np.sqrt(np.partition(d2, k_sub, axis=1)[:, k_sub])
    r = float(np.median(kth))
    diag = float(np.linalg.norm(pos.max(0) - pos.min(0))) or 1.0
    return float(np.clip(r, 1e-4 * diag, 0.1 * diag))


def build_photon_maps(scene: Scene, static: SceneStatic, cfg: RenderConfig,
                      key: jax.Array,
                      path_tracing: Optional[bool] = None,
                      mesh=None, return_stats: bool = False):
    """Scene::tracePhotons + traceCausticPhotons: emit batches until the
    stored-photon target is reached, scale powers by 1/total_emitted
    (Scene.cpp:402), build the hashed grids.

    With `mesh`, emission batches are sharded across the devices
    (trace_photon_batch_sharded) — the reference's second parallel
    dimension (OpenMP photon batches, Scene.cpp:372-394).

    return_stats=True returns (PhotonMaps, stats_dict) where stats_dict
    holds the -DSTATS photon counters (Stats.h): emitted / stored /
    bounces per map.

    DETACHMENT BOUNDARY: this builder rounds photon positions, powers
    and directions through host numpy (np.asarray at the batch
    boundary), so the built PhotonMaps is a CONSTANT w.r.t. light and
    material parameters — d(image)/d(wattage or kd) does NOT flow
    through photon emission, mirroring the reference's precompute split
    (preCalc vs render, Scene.cpp:50-84). Gradients DO flow through the
    gather: d(image)/d(stored photon power) is exact
    (grid_irradiance is plain jnp; FD-tested in
    tests/test_grad_oracle.py::test_grad_photon_power)."""
    if path_tracing is None:
        path_tracing = cfg.path_tracing
    kinds = np.asarray(scene.lights.kind)
    emitters = [i for i in range(kinds.shape[0])
                if kinds[i] == LIGHT_DIRECTIONAL_AREA]
    if not emitters:
        return (None, {}) if return_stats else None

    # Scene.cpp:375 uses OMP batches of 10000; the CPU keeps them, and
    # accelerators take wider wavefronts, which spread each batch's
    # launches and host round trip over more photons
    batch = 10000 if jax.default_backend() == "cpu" else 65536
    if mesh is not None:
        batch = -(-batch // mesh.size) * mesh.size
    maps = {}
    stats = {}
    for caustic, target in ((False, cfg.photons_per_light),
                            (True, cfg.caustic_photons_per_light)):
        name = "caustic" if caustic else "global"
        stats[name] = dict(emitted=0, stored=0, bounces=0)
        if target <= 0:
            maps[caustic] = None
            continue
        if mesh is not None:
            fn = jax.jit(trace_photon_batch_sharded,
                         static_argnames=("static", "light_i", "n_emit",
                                          "caustic", "depth_limit",
                                          "path_tracing", "mesh"))
            fn = lambda *a, _fn=fn, **kw: _fn(*a, mesh=mesh, **kw)
        else:
            fn = jax.jit(trace_photon_batch,
                         static_argnames=("static", "light_i", "n_emit",
                                          "caustic", "depth_limit",
                                          "path_tracing"))
        all_pos, all_dir, all_pow = [], [], []
        total_emitted = 0
        stored = 0
        for li in emitters:
            li_stored = 0
            it = 0
            while li_stored < target and it < cfg.photon_max_batches:
                key, sk = jax.random.split(key)
                out = fn(scene, static=static, light_i=li, n_emit=batch,
                         caustic=caustic,
                         depth_limit=cfg.trace_depth_photons,
                         path_tracing=path_tracing, key=sk)
                m2 = np.asarray(out.mask)
                m = m2.reshape(-1)
                all_pos.append(np.asarray(out.pos).reshape(-1, 3)[m])
                all_dir.append(np.asarray(out.dir).reshape(-1, 3)[m])
                all_pow.append(np.asarray(out.power).reshape(-1, 3)[m])
                li_stored += int(m.sum())
                total_emitted += batch
                stats[name]["bounces"] += int(np.asarray(out.bounces).sum())
                # DEBUG_PHOTONS-style ledger (Scene.cpp:20-30): how many
                # photons stored at each bounce depth
                per_level = m2.sum(axis=1).astype(int).tolist()
                acc = stats[name].setdefault("stored_per_level",
                                             [0] * len(per_level))
                for d_, c_ in enumerate(per_level):
                    acc[d_] += c_
                it += 1
            stored += li_stored
        stats[name]["emitted"] = total_emitted
        stats[name]["stored"] = stored
        if stored == 0:
            maps[caustic] = None
            continue
        pos = np.concatenate(all_pos)[:target * len(emitters)]
        dirs = np.concatenate(all_dir)[:target * len(emitters)]
        pows = (np.concatenate(all_pow)[:target * len(emitters)]
                / max(total_emitted, 1))              # scale_photon_power
        radius = _auto_radius(pos, cfg.photon_samples,
                              cfg.photon_grid_max_per_cell)
        maps[caustic] = build_grid(
            pos, pows, dirs, radius, cfg.photon_grid_max_per_cell,
            knn=cfg.photon_samples,
            coarse_factor=(cfg.photon_coarse_factor
                           if cfg.photon_coarse_factor > 0 else None))
    pm = PhotonMaps(global_map=maps[False], caustic_map=maps[True])
    return (pm, stats) if return_stats else pm

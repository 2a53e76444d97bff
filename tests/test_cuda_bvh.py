"""The CUDA traversal's host side, on the CPU: the arrays the kernel reads
(csrc/bvh_trace.cu), the ray staging, the platform choice of `auto`, and
the stop_gradient rule. The kernel itself has no CPU mode; its tests are
marked `gpu` and skip here (they run on the card: `JAX_PLATFORMS=cuda
python -m pytest -m gpu tests/test_cuda_bvh.py`, and as a phase of
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cse168_raytracer.config import EPSILON, RenderConfig
from cse168_raytracer.models.geometry import pack_triangles
from cse168_raytracer.ops.accel import attach_accel, default_kind
from cse168_raytracer.ops.cuda_bvh import (BLOCK, LEAF_SHIFT,
                                           build_cuda_bvh,
                                           cuda_closest_hit_triangles,
                                           decode_link, pack_rays)
from cse168_raytracer.ops.intersect import _BIG, _DEN_TINY, \
    accept_bounds, intersect_triangles
from cse168_raytracer.scenes.registry import model_ctm, torus_knot


def _knot_pack(**kw):
    mesh = torus_knot(ctm=model_ctm(position=(0.3, 1.0, -0.2), rot_y=0.7,
                                    scl=(1.5, 1.5, 1.5)), **kw)
    return pack_triangles([(mesh, 0)])


def _rays(pack, n, seed=7):
    rng = np.random.default_rng(seed)
    v = np.asarray(pack.v0)[np.asarray(pack.valid)]
    lo, hi = v.min(0), v.max(0)
    c, ext = (lo + hi) / 2, (hi - lo).max()
    o = (c + rng.normal(0, 2 * ext, (n, 3))).astype(np.float32)
    tgt = (c + rng.normal(0, 0.3 * ext, (n, 3))).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _boxes(nodes):
    f = np.asarray(nodes).view(np.float32)
    return f[:, 0:3], f[:, 3:6], f[:, 6:9], f[:, 9:12]


def walk(nodes, tris, o, d, tmin, tmax, any_hit=False):
    """The kernel's walk in numpy float32, reading the very arrays the
    kernel reads: the CPU oracle of the layout. Returns per-ray
    (t, row, box_tests, tri_tests)."""
    nodes = np.asarray(nodes)
    fb = nodes.view(np.float32)
    tris = np.asarray(tris, np.float32)
    f32 = np.float32
    out = []
    for i in range(o.shape[0]):
        oo, dd = o[i].astype(f32), d[i].astype(f32)
        with np.errstate(divide="ignore", invalid="ignore"):
            rcp = f32(1) / dd
        m = np.cross(oo, dd).astype(f32)
        r6 = np.concatenate([dd, m])
        r4 = np.concatenate([oo, [f32(1)]])
        t0, t1 = f32(tmin[i]), f32(tmax[i])
        best_t, best_id, n_box, n_tri = f32(_BIG), 0, 0, 0

        def slab(lo, hi, cur):
            with np.errstate(invalid="ignore"):
                a = (lo - oo) * rcp
                b = (hi - oo) * rcp
            nan = np.isnan(a) | np.isnan(b)
            tn = np.where(nan, -np.inf, np.minimum(a, b)).max()
            tf = np.where(nan, np.inf, np.maximum(a, b)).min()
            enter = max(tn, t0)
            return enter, enter <= min(tf, cur)

        stack = []
        link = 0
        live = t1 >= t0
        while live:
            if link >= 0:
                cur = min(t1, best_t)
                tl, hl = slab(fb[link, 0:3], fb[link, 3:6], cur)
                tr, hr = slab(fb[link, 6:9], fb[link, 9:12], cur)
                n_box += 2
                ll, lr = int(nodes[link, 12]), int(nodes[link, 13])
                if hl and hr:
                    near_l = tl <= tr
                    stack.append((lr, tr) if near_l else (ll, tl))
                    link = ll if near_l else lr
                    continue
                if hl or hr:
                    link = ll if hl else lr
                    continue
            else:
                _, first, count = decode_link(link)
                first, count = int(first), int(count)
                n_tri += count
                done = False
                for j in range(first, first + count):
                    row = tris[j]
                    nb = np.dot(r6, row[0:6])
                    ng = np.dot(r6, row[6:12])
                    den = np.dot(dd, row[12:15])
                    tn = np.dot(r4, row[15:19])
                    ok_den = abs(den) >= _DEN_TINY
                    inv = f32(1) / (den if ok_den else f32(1))
                    beta, gamma, t = nb * inv, ng * inv, tn * inv
                    if (ok_den and beta >= -EPSILON and gamma >= -EPSILON
                            and beta + gamma <= 1 + EPSILON and t >= t0
                            and t <= t1 and t < best_t):
                        best_t, best_id = t, j
                        if any_hit:
                            done = True
                            break
                if done:
                    break
            link = None
            while stack:
                cand, te = stack.pop()
                if te <= min(t1, best_t):
                    link = cand
                    break
            if link is None:
                break
        out.append((best_t, best_id, n_box, n_tri))
    t, row, box, tri = map(np.asarray, zip(*out))
    return t, row, box, tri


@pytest.fixture(scope="module")
def knot_bvh():
    pack = _knot_pack()
    new_pack, accel = build_cuda_bvh(pack)
    return pack, new_pack, accel


def test_cuda_layout_invariants(knot_bvh):
    """Every valid triangle sits in exactly one leaf, leaves are compact
    and in row order, every internal node but the root has one parent,
    and each child box bounds what lies below it."""
    pack, new_pack, accel = knot_bvh
    nodes = np.asarray(accel.nodes)
    assert nodes.dtype == np.int32 and nodes.shape[1] == 16
    assert np.all(nodes[:, 14:] == 0)
    n_valid = int(np.asarray(pack.valid).sum())
    valid = np.asarray(new_pack.valid)
    assert valid[:n_valid].all() and not valid[n_valid:].any()
    assert new_pack.num_tris % 128 == 0

    links = nodes[:, 12:14].reshape(-1)
    is_leaf, idx, cnt = decode_link(links)
    internal = idx[~is_leaf]
    assert np.array_equal(np.sort(internal), np.arange(1, nodes.shape[0]))
    firsts, counts = idx[is_leaf], cnt[is_leaf]
    assert counts.max() <= accel.leaf_size and counts.min() >= 1
    covered = np.concatenate([np.arange(f, f + c)
                              for f, c in zip(firsts, counts)])
    assert np.array_equal(np.sort(covered), np.arange(n_valid))

    # leaf boxes hold each triangle's acceptance band (not only its
    # vertices), and every box holds the boxes below it, exactly
    t_lo, t_hi = accept_bounds(new_pack.v0, new_pack.e1, new_pack.e2)
    v0 = np.asarray(new_pack.v0)
    assert np.all(t_lo <= v0) and np.all(t_hi >= v0)
    lo_l, hi_l, lo_r, hi_r = _boxes(nodes)
    lo = np.stack([lo_l, lo_r], 1).reshape(-1, 3)
    hi = np.stack([hi_l, hi_r], 1).reshape(-1, 3)
    for k in np.nonzero(is_leaf)[0]:
        rows = slice(idx[k], idx[k] + cnt[k])
        assert np.all(t_lo[rows] >= lo[k]) and np.all(t_hi[rows] <= hi[k])
    for k in np.nonzero(~is_leaf)[0]:
        c = idx[k]
        assert np.all(lo[k] <= np.minimum(lo_l[c], lo_r[c]))
        assert np.all(hi[k] >= np.maximum(hi_l[c], hi_r[c]))
    assert accel.stack_depth <= 64


def test_cuda_tri_table_is_the_packs_plucker_operands(knot_bvh):
    """The kernel tests the same float32 operands as the brute-force
    oracle: rows are w6's beta/gamma/den columns and w4, in pack order."""
    _, new_pack, accel = knot_bvh
    tab = np.asarray(accel.tris)
    w6 = np.asarray(new_pack.w6)
    w4 = np.asarray(new_pack.w4)
    assert tab.shape == (new_pack.num_tris, 20)
    np.testing.assert_array_equal(tab[:, 0:6], w6[:, :, 0].T)
    np.testing.assert_array_equal(tab[:, 6:12], w6[:, :, 1].T)
    np.testing.assert_array_equal(tab[:, 12:15], w6[0:3, :, 2].T)
    assert np.all(w6[3:6, :, 2] == 0)
    np.testing.assert_array_equal(tab[:, 15:19], w4.T)
    assert np.all(tab[:, 19] == 0)


@pytest.mark.parametrize("any_hit", [False, True])
def test_cuda_layout_walk_matches_brute_force(knot_bvh, any_hit):
    """The kernel's walk over the kernel's arrays (numpy, float32)
    agrees with ops/intersect.py: same hit mask, same t, same triangle
    up to exact-t ties; any-hit finds a hit inside [tmin, tmax]."""
    _, new_pack, accel = knot_bvh
    o, d = _rays(new_pack, 300)
    tmin = np.zeros(300, np.float32)
    tmax = np.full(300, 1e10, np.float32)
    tmax[::7] = -1.0                       # dead lanes: never traverse
    ref = intersect_triangles(new_pack, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(tmin), jnp.asarray(tmax))
    t, row, box, tri = walk(accel.nodes, accel.tris, o, d, tmin, tmax,
                            any_hit=any_hit)
    hit = t < _BIG
    assert np.array_equal(hit, np.asarray(ref.hit))
    assert hit.sum() > 50
    assert np.all(box[::7] == 0) and np.all(tri[::7] == 0)
    assert np.all(box[hit] >= 2) and np.all(tri[hit] >= 1)
    if any_hit:
        assert np.all(t[hit] <= tmax[hit]) and np.all(t[hit] >= 0)
        return
    # 1e-5 relative, plus 1e-6 absolute: t = (o.n - A.n) / den cancels
    # at the scene's coordinate scale (~5 * 2^-24 per term)
    np.testing.assert_allclose(t[hit], np.asarray(ref.t)[hit], rtol=1e-5,
                               atol=1e-6)
    assert np.mean(row[hit] == np.asarray(ref.prim_id)[hit]) > 0.99
    # far fewer triangle tests than brute force
    assert tri[hit].mean() < 0.05 * new_pack.num_tris


def _isolated_pack(n=96, seed=5):
    """n unit-sized triangles scattered through a large cube, so a ray
    aimed just past one triangle's edge meets nothing else nearby."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-40, 40, (n, 1, 3))
    v = (c + rng.normal(0, 1, (n, 3, 3))).reshape(-1, 3).astype(np.float32)
    f = np.arange(3 * n).reshape(n, 3)
    mesh = {"vertices": v, "normals": np.tile([[0.0, 0.0, 1.0]], (3 * n, 1)),
            "texcoords": np.zeros((0, 2), np.float32), "tri_vidx": f,
            "tri_nidx": f, "tri_tidx": np.full((n, 3), -1)}
    return pack_triangles([(mesh, 0)])


def _band_rays(pack, seed=9):
    """Rays aimed at points outside each triangle but inside its
    acceptance band (barycentrics within EPSILON of an edge), just past
    each corner. Returns (o, d, share of the aim points outside the
    triangle's vertex box)."""
    rng = np.random.default_rng(seed)
    valid = np.asarray(pack.valid)
    v0, e1, e2 = (np.asarray(a, np.float64)[valid]
                  for a in (pack.v0, pack.e1, pack.e2))
    h = EPSILON / 2
    bary = [(-h, -h), (1 + h, -h / 2), (-h / 2, 1 + h)]
    p = np.concatenate([v0 + b * e1 + g * e2 for b, g in bary])
    n = np.cross(e1, e2)
    n = np.tile(n / np.linalg.norm(n, axis=1, keepdims=True), (3, 1))
    side = np.where(rng.random((len(p), 1)) < 0.5, -1.0, 1.0)
    o = p + side * 3 * n + rng.normal(0, 0.3, p.shape)
    d = (p - o) / np.linalg.norm(p - o, axis=1, keepdims=True)
    pts = np.stack([v0, v0 + e1, v0 + e2], 1)
    lo, hi = np.tile(pts.min(1), (3, 1)), np.tile(pts.max(1), (3, 1))
    outside = np.any((p < lo) | (p > hi), axis=1)
    return o.astype(np.float32), d.astype(np.float32), outside.mean()


def test_accept_bounds_hold_the_band():
    """accept_bounds holds every point with barycentrics in the
    acceptance band (beta, gamma >= -EPSILON, beta + gamma <= 1 +
    EPSILON), which reaches past the vertices' own box."""
    rng = np.random.default_rng(2)
    v0, e1, e2 = (rng.normal(0, 3, (500, 3)) for _ in range(3))
    lo, hi = accept_bounds(v0, e1, e2)
    assert lo.dtype == hi.dtype == np.float32
    u = rng.uniform(-EPSILON, 1 + 2 * EPSILON, (500, 64, 2))
    u = np.where(u.sum(-1, keepdims=True) > 1 + EPSILON,
                 1 + EPSILON - u[..., ::-1], u)
    u = np.clip(u, -EPSILON, None)
    corners = np.array([[-EPSILON, -EPSILON], [1 + 2 * EPSILON, -EPSILON],
                        [-EPSILON, 1 + 2 * EPSILON]])
    u = np.concatenate([u, np.broadcast_to(corners, (500, 3, 2))], axis=1)
    p = v0[:, None] + u[..., :1] * e1[:, None] + u[..., 1:] * e2[:, None]
    assert np.all(p >= lo[:, None]) and np.all(p <= hi[:, None])
    pts = np.stack([v0, v0 + e1, v0 + e2], 1)
    assert np.all(lo < pts.min(1)) and np.all(hi > pts.max(1))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kind", ["cuda", "bvh", "block"])
def test_band_hits_match_brute_force(kind, any_hit):
    """Acceptance widens each triangle by EPSILON in barycentrics, so a
    hit can lie outside the triangle's vertex box. Every accelerator's
    boxes must bound that band: rays aimed into it hit exactly where
    brute force hits."""
    from cse168_raytracer.ops.accel import (accel_any_hit_triangles,
                                            accel_intersect_triangles,
                                            build_accel, morton_order,
                                            reorder_pack)
    from cse168_raytracer.ops.bvh import build_bvh, \
        bvh_closest_hit_triangles
    pack = _isolated_pack()
    o, d, outside = _band_rays(pack)
    assert outside > 0.5          # the band reaches past the vertex box
    n = o.shape[0]
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1e10, np.float32)
    ref = intersect_triangles(pack, jnp.asarray(o), jnp.asarray(d), 0.0,
                              1e10)
    ref_hit, ref_t = np.asarray(ref.hit), np.asarray(ref.t)
    assert ref_hit.all()
    if kind == "cuda":
        _, accel = build_cuda_bvh(pack)
        t, _, _, _ = walk(accel.nodes, accel.tris, o, d, tmin, tmax,
                          any_hit=any_hit)
        hit = t < _BIG
    else:
        perm = morton_order(np.asarray(pack.v0), np.asarray(pack.e1),
                            np.asarray(pack.e2), np.asarray(pack.valid))
        sorted_pack = reorder_pack(pack, perm)
        oj, dj = jnp.asarray(o), jnp.asarray(d)
        if kind == "bvh":
            h = bvh_closest_hit_triangles(build_bvh(sorted_pack, leaf_size=4),
                                          oj, dj, 0.0, 1e10, any_hit=any_hit)
            hit, t = np.asarray(h.hit), np.asarray(h.t)
        elif any_hit:
            hit = np.asarray(accel_any_hit_triangles(
                build_accel(sorted_pack), sorted_pack, oj, dj, 0.0, 1e10))
            t = ref_t
        else:
            h = accel_intersect_triangles(build_accel(sorted_pack),
                                          sorted_pack, oj, dj, 0.0, 1e10)
            hit, t = np.asarray(h.hit), np.asarray(h.t)
    assert np.array_equal(hit, ref_hit), f"{(~hit).sum()} of {n} band " \
        "rays missed"
    if not any_hit:
        np.testing.assert_allclose(t, ref_t, rtol=1e-5)


@pytest.mark.parametrize("n_tri", [0, 1, 5, 33])
def test_cuda_tiny_meshes(n_tri):
    """Degenerate trees: no triangles (root over two empty leaves), one
    leaf wrapped in a root node, and root children that are leaves."""
    rng = np.random.default_rng(3)
    if n_tri:
        v = rng.normal(0, 1, (n_tri * 3, 3)).astype(np.float32)
        f = np.arange(n_tri * 3).reshape(n_tri, 3)
        mesh = {"vertices": v,
                "normals": np.tile([[0.0, 0.0, 1.0]], (n_tri * 3, 1)),
                "texcoords": np.zeros((0, 2), np.float32),
                "tri_vidx": f, "tri_nidx": f,
                "tri_tidx": np.full((n_tri, 3), -1)}
        pack = pack_triangles([(mesh, 0)])
    else:
        from cse168_raytracer.models.geometry import empty_triangle_pack
        pack = empty_triangle_pack()
    new_pack, accel = build_cuda_bvh(pack)
    o = np.zeros((64, 3), np.float32) + np.array([0, 0, -5], np.float32)
    d = rng.normal(0, 1, (64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(64, np.float32)
    tmax = np.full(64, 1e10, np.float32)
    ref = intersect_triangles(pack, jnp.asarray(o), jnp.asarray(d), 0.0,
                              1e10)
    t, _, _, _ = walk(accel.nodes, accel.tris, o, d, tmin, tmax)
    assert np.array_equal(t < _BIG, np.asarray(ref.hit)), n_tri
    both = t < _BIG
    np.testing.assert_allclose(t[both], np.asarray(ref.t)[both], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("block", [64, 128, 256])
@pytest.mark.parametrize("n", [1, BLOCK - 1, BLOCK, BLOCK + 1, 1000])
def test_pack_rays_pads_to_the_block(n, block):
    """Rays are staged as (8, N_pad) rows; N_pad is the next multiple of
    the CUDA block and the padding rays are dead (tmax < tmin)."""
    rng = np.random.default_rng(n)
    o = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    tmax = jnp.asarray(rng.uniform(1, 2, n), jnp.float32)
    rows, n_pad = pack_rays(o, d, 0.5, tmax, block)
    rows = np.asarray(rows)
    assert n_pad % block == 0 and n <= n_pad < n + block
    assert rows.shape == (8, n_pad) and rows.dtype == np.float32
    np.testing.assert_array_equal(rows[0:3, :n], np.asarray(o).T)
    np.testing.assert_array_equal(rows[3:6, :n], np.asarray(d).T)
    assert np.all(rows[6, :n] == 0.5)
    np.testing.assert_array_equal(rows[7, :n], np.asarray(tmax))
    pad = rows[:, n:]
    assert np.all(pad[7] < pad[6])
    assert np.all(pad[5] == 1.0) and np.all(pad[[0, 1, 2, 3, 4]] == 0)


def test_cuda_block_size_is_an_attach_option():
    """attach_accel(kind="cuda", block=...) carries the CUDA block size
    to the kernel call as a static field; sizes past the kernel's launch
    bound, and the option on other kinds, are refused."""
    from cse168_raytracer.ops.cuda_bvh import MAX_BLOCK
    from cse168_raytracer.scenes import build
    scene, _, _, _ = build("knot", RenderConfig(width=8, height=8))
    assert attach_accel(scene, kind="cuda").accel.block == BLOCK
    a256 = attach_accel(scene, kind="cuda", block=256).accel
    assert a256.block == 256
    assert jax.tree_util.tree_structure(a256) != \
        jax.tree_util.tree_structure(attach_accel(scene, kind="cuda").accel)
    for bad in (0, MAX_BLOCK + 1):
        with pytest.raises(ValueError, match="block"):
            attach_accel(scene, kind="cuda", block=bad)
    with pytest.raises(TypeError, match="unsupported options"):
        attach_accel(scene, kind="block", block=64)


def test_leaf_link_encoding_round_trips():
    from cse168_raytracer.ops.cuda_bvh import encode_leaf
    first = np.array([0, 1, 7, (1 << (31 - LEAF_SHIFT)) - 1])
    count = np.array([1, 4, 63, 2])
    links = encode_leaf(first, count).astype(np.int32)
    assert np.all(links < 0)
    is_leaf, f, c = decode_link(links)
    assert is_leaf.all()
    np.testing.assert_array_equal(f, first)
    np.testing.assert_array_equal(c, count)


@pytest.mark.parametrize("backend,kind", [("gpu", "cuda"), ("cpu", "block"),
                                          ("rocm", None), ("metal", None)])
def test_auto_kind_by_platform(backend, kind):
    """`auto` names its choice per platform and refuses the rest."""
    if kind is None:
        with pytest.raises(ValueError, match="no traversal"):
            default_kind(backend)
    else:
        assert default_kind(backend) == kind


def test_auto_on_cpu_attaches_block_and_rejects_unknown_kinds():
    from cse168_raytracer.ops.accel import BlockAccel
    from cse168_raytracer.scenes import build
    scene, _, _, _ = build("knot", RenderConfig(width=8, height=8))
    assert isinstance(attach_accel(scene).accel, BlockAccel)
    with pytest.raises(ValueError, match="unknown accelerator kind"):
        attach_accel(scene, kind="wide4")


def test_cuda_trace_needs_a_gpu(knot_bvh):
    """Off the GPU the wrapper stops with a clear error instead of
    lowering a custom call the backend does not have."""
    _, _, accel = knot_bvh
    o = jnp.zeros((4, 3))
    d = jnp.ones((4, 3))
    with pytest.raises(RuntimeError, match="only on an NVIDIA GPU"):
        cuda_closest_hit_triangles(accel, o, d, 0.0, 1.0)


@pytest.mark.parametrize("param", ["kd", "light", "lift"])
def test_grad_through_accel_equals_brute_force(param):
    """The stop_gradient rule: traversal is detached and the winner's
    surface recomputed differentiably, so the gradient through an
    accelerated render equals the gradient through brute force — for
    material, light and vertex parameters alike."""
    from cse168_raytracer.render.integrator import render_hdr
    from cse168_raytracer.scenes import build
    cfg = RenderConfig(width=16, height=16, trace_depth=1)
    scene, static, cam, cfg = build("knot", cfg)
    accel = attach_accel(scene, kind="block")
    key = jax.random.key(0)

    def loss(s, x):
        if param == "kd":
            s = s.replace(materials=s.materials._replace(kd=x))
        elif param == "light":
            s = s.replace(lights=s.lights._replace(position=x))
        else:
            up = jnp.array([0.0, 1.0, 0.0]) * x
            s = s.replace(tris=s.tris._replace(v0=s.tris.v0 + up))
        return jnp.sum(render_hdr(s, static, cam, cfg, key)[0])

    x0 = {"kd": scene.materials.kd, "light": scene.lights.position,
          "lift": jnp.float32(0.0)}[param]
    g = jax.jit(jax.grad(loss, argnums=1))
    g_brute = np.asarray(g(scene, x0))
    g_accel = np.asarray(g(accel, x0))
    assert np.isfinite(g_brute).all() and np.abs(g_brute).sum() > 0
    np.testing.assert_allclose(g_accel, g_brute, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# On the card only (marker `gpu`): the compiled kernel itself
# ---------------------------------------------------------------------------

@pytest.fixture
def on_gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("the CUDA kernel runs only on an NVIDIA GPU; "
                    "run with JAX_PLATFORMS=cuda on the card")


@pytest.mark.gpu
def test_cuda_kernel_matches_layout_walk(on_gpu, knot_bvh):
    """The compiled kernel returns what the numpy walk of its arrays
    returns: hits, t (1e-5 relative: FMA contraction), and the same
    counters wherever the two pick the same triangle."""
    _, new_pack, accel = knot_bvh
    o, d = _rays(new_pack, 2000, seed=11)
    tmin = np.zeros(2000, np.float32)
    tmax = np.full(2000, 1e10, np.float32)
    h, box, tri = jax.jit(lambda a, o, d: cuda_closest_hit_triangles(
        a, o, d, 0.0, 1e10, with_stats=True))(accel, o, d)
    t, row, wbox, wtri = walk(accel.nodes, accel.tris, o, d, tmin, tmax)
    hit = t < _BIG
    assert np.array_equal(np.asarray(h.hit), hit)
    np.testing.assert_allclose(np.asarray(h.t)[hit], t[hit], rtol=1e-5,
                               atol=1e-6)
    same = np.asarray(h.prim_id) == row
    assert same[hit].mean() > 0.99
    assert np.mean(np.asarray(box)[same] == wbox[same]) > 0.99
    assert np.mean(np.asarray(tri)[same] == wtri[same]) > 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
def test_cuda_kernel_hits_the_band(on_gpu, any_hit):
    """The compiled kernel accepts hits in each triangle's EPSILON band
    past its vertex box exactly where brute force does."""
    pack = _isolated_pack()
    o, d, _ = _band_rays(pack)
    _, accel = build_cuda_bvh(pack)
    ref = intersect_triangles(pack, jnp.asarray(o), jnp.asarray(d), 0.0,
                              1e10)
    h = jax.jit(lambda a, o, d: cuda_closest_hit_triangles(
        a, o, d, 0.0, 1e10, any_hit=any_hit))(accel, o, d)
    assert np.asarray(ref.hit).all()
    assert np.array_equal(np.asarray(h.hit), np.asarray(ref.hit))
    if not any_hit:
        np.testing.assert_allclose(np.asarray(h.t), np.asarray(ref.t),
                                   rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bvh", "block"])
def test_cuda_render_matches_xla_traversals(on_gpu, kind):
    """A 64x64 knot render through the kernel matches the XLA walks to
    the golden criterion (>= 99.9% of tonemapped pixels within 2/255)."""
    from cse168_raytracer.render.integrator import render_hdr
    from cse168_raytracer.render.tonemap import sigmoid_tonemap, to_bytes
    from cse168_raytracer.scenes import build
    cfg = RenderConfig(width=64, height=64, trace_depth=2)
    scene, static, cam, cfg = build("knot", cfg)
    imgs = {}
    for k in ("cuda", kind):
        s = attach_accel(scene, kind=k)
        hdr, _ = jax.jit(lambda s: render_hdr(s, static, cam, cfg,
                                              jax.random.key(0)))(s)
        imgs[k] = np.asarray(to_bytes(sigmoid_tonemap(hdr))).astype(int)
    close = np.abs(imgs["cuda"] - imgs[kind]) <= 2
    assert close.mean() >= 0.999, close.mean()

"""deplex_tpu_torch.slam vs deplex_tpu.slam on seeded synthetic worlds.

The same numpy inputs go through both packages (the worlds and problems of
tests/test_slam.py). Tolerances are float32 ones: the two packages round
their sums, products and transcendentals in other orders, so values agree
to a few units in the last place, and a Gauss-Newton step (one solve of a
normal-equation system) amplifies that by the system's conditioning.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from deplex_tpu.slam import ba as jba
from deplex_tpu.slam import lie as jlie
from deplex_tpu.slam import planes as jplanes
from deplex_tpu.slam import pose_graph as jpg
from deplex_tpu.slam.association import associate as jassociate
from deplex_tpu.slam.odometry import estimate_pose as jestimate_pose
from deplex_tpu_torch.interop import (ba_problem_from_numpy, fields_of,
                                      plane_obs_from_numpy, pose_graph_from_numpy)
from deplex_tpu_torch.slam import ba, lie, planes, pose_graph
from deplex_tpu_torch.slam.association import associate
from deplex_tpu_torch.slam.odometry import estimate_pose

# The reference's functions, jitted (op-by-op dispatch of its BA and pose
# graph takes tens of seconds on the CPU).
J_BA_STEP = jax.jit(functools.partial(jba.ba_step, damping=1e-4))
J_BA_COST = jax.jit(jba.ba_cost)
J_RUN_BA = jax.jit(jba.run_ba, static_argnames=("iterations",))
J_ODO_BLOCKS = jax.jit(jba._odo_blocks)
J_CV_BLOCKS = jax.jit(jba._cv_blocks)
J_OBS_TERMS = jax.jit(jax.vmap(jba._residual_and_jac))
J_PG_STEP = jax.jit(jpg.pose_graph_step)
J_GRAPH_COST = jax.jit(jpg.graph_cost)
J_OPTIMIZE_PG = jax.jit(jpg.optimize_pose_graph, static_argnames=("iterations",))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def T(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def close(got, ref, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=rtol)


def rand_rotation(rng, scale=0.5):
    return np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3) * scale, jnp.float32)))


def make_world(rng, m=12):
    """Random well-spread unit normals + offsets (tests/test_slam.py)."""
    n = rng.normal(size=(m, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    d = rng.uniform(500, 3000, size=m).astype(np.float32)
    return n.astype(np.float32), d


def make_problem(rng, K=5, M=10, noise=0.0):
    """A BA problem observed exactly (or with noise) from K poses, as
    tests/test_slam.py's TestBA._make_problem; numpy fields."""
    n_w, d_w = make_world(rng, m=M)
    eta = np.asarray(jplanes.to_cp(jnp.asarray(n_w), jnp.asarray(d_w)))
    Rs, ts = [np.eye(3, dtype=np.float32)], [np.zeros(3, np.float32)]
    for _ in range(K - 1):
        Rs.append(rand_rotation(rng, 0.15).astype(np.float32))
        ts.append((rng.normal(size=3) * 60).astype(np.float32))
    R, t = np.stack(Rs), np.stack(ts)
    n_c = np.einsum("kij,mj->kmi", R, n_w)
    d_c = d_w[None] - np.einsum("kmi,ki->km", n_c, t)
    n_c = n_c + noise * rng.normal(size=n_c.shape)
    n_c = (n_c / np.linalg.norm(n_c, axis=-1, keepdims=True)).astype(np.float32)
    d_c = (d_c + noise * 100 * rng.normal(size=d_c.shape)).astype(np.float32)
    return dict(R=R, t=t, eta=eta, obs_normal=n_c, obs_d=d_c,
                obs_lm=np.broadcast_to(np.arange(M), (K, M)).astype(np.int32),
                obs_w=np.ones((K, M), np.float32))


def perturbed(fields, rng, rot=0.02, tr=10.0, eta=5.0):
    """Perturb every pose but the first, and the landmarks."""
    K = fields["R"].shape[0]
    xi = rng.normal(size=(K, 6)).astype(np.float32) * np.array([rot] * 3 + [tr] * 3, np.float32)
    xi[0] = 0.0
    dR, dt = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(xi)))
    out = dict(fields)
    out["R"] = np.einsum("kij,kjl->kil", dR, fields["R"]).astype(np.float32)
    out["t"] = (np.einsum("kij,kj->ki", dR, fields["t"]) + dt).astype(np.float32)
    out["eta"] = (fields["eta"] + rng.normal(size=fields["eta"].shape) * eta).astype(np.float32)
    return out


def with_priors(fields, rng, odo_w=10.0, cv_w=100.0, chain=None):
    """Add odometry priors measured on `chain` (default: the problem's own
    poses) plus noise, and constant-velocity priors."""
    K = fields["R"].shape[0]
    R, t = (chain or fields)["R"], (chain or fields)["t"]
    odo_R = np.einsum("kij,klj->kil", R[:-1], R[1:]).astype(np.float32)
    odo_t = (t[:-1] - np.einsum("kij,kj->ki", odo_R, t[1:])
             + rng.normal(size=(K - 1, 3)) * 2.0).astype(np.float32)
    return dict(fields, odo_R=odo_R, odo_t=odo_t, odo_w=np.full(K - 1, odo_w, np.float32),
                cv_w=np.full(K - 2, cv_w, np.float32))


def jax_problem(fields):
    return jba.BAProblem(**{k: None if v is None else jnp.asarray(v) for k, v in fields.items()})


def f64_fields(fields):
    """The float32 fields of `fields` as float64."""
    return {k: np.asarray(v, np.float64) if v is not None and np.asarray(v).dtype == np.float32
            else v for k, v in fields.items()}


def to_f64(nt):
    """A NamedTuple of tensors with its floating fields in float64."""
    return nt._replace(**{k: v.double() for k, v in nt._asdict().items()
                          if v is not None and v.is_floating_point()})


def held_to_jax(got, got64, ref, ref64, fields):
    """The port against the reference, one Gauss-Newton result each in
    float32 and in float64. In float64 both compute the same math and agree
    to 1e-7 of the largest value. In float32 a step amplifies rounding by the
    normal equations' conditioning, so the port's float32 result must lie as
    close to the float64 one as the reference's float32 result does, within
    a factor 4 (plus 1e-6 of the largest value)."""
    for name in fields:
        g, g64, r, r64 = (np.asarray(getattr(x, name), np.float64)
                          for x in (got, got64, ref, ref64))
        scale = max(float(np.abs(r64).max()), 1e-30)
        np.testing.assert_allclose(g64, r64, atol=1e-7 * scale, err_msg=name)
        bound = 4.0 * float(np.abs(r - r64).max()) + 1e-6 * scale
        assert float(np.abs(g - r64).max()) <= bound, (name, np.abs(g - r64).max(), bound)


# ---------------------------------------------------------------- lie, planes

def test_lie_matches_jax():
    rng = np.random.default_rng(0)
    phi = (rng.normal(size=(32, 3)) * 0.8).astype(np.float32)
    phi[0] = 0.0
    phi[1] = 1e-7
    xi = np.concatenate([phi, rng.normal(size=(32, 3)).astype(np.float32) * 50], 1)
    close(lie.so3_exp(T(phi)), jlie.so3_exp(jnp.asarray(phi)), atol=1e-6)
    R = np.asarray(jlie.so3_exp(jnp.asarray(phi)))
    close(lie.so3_log(T(R)), jlie.so3_log(jnp.asarray(R)), atol=2e-6)
    Rg, tg = lie.se3_exp(T(xi))
    Rj, tj = jlie.se3_exp(jnp.asarray(xi))
    close(Rg, Rj, atol=1e-6)
    close(tg, tj, atol=1e-4, rtol=1e-5)
    close(lie.so3_log(lie.so3_exp(T(phi))), phi, atol=1e-4)
    Ri, ti = lie.se3_inverse(*lie.se3_compose(Rg, tg, Rg, tg))
    Rji, tji = jlie.se3_inverse(*jlie.se3_compose(Rj, tj, Rj, tj))
    close(Ri, Rji, atol=2e-6)
    close(ti, tji, atol=1e-3, rtol=1e-5)
    p = rng.normal(size=(32, 3)).astype(np.float32) * 100
    close(lie.se3_apply(Rg, tg, T(p)), jlie.se3_apply(Rj, tj, jnp.asarray(p)), atol=1e-3)


def test_lie_jacobians_at_zero_finite_and_equal_jax():
    """so3_exp, so3_log and se3_exp differentiate at xi = 0 (BA's
    linearization point) through their safe branches."""
    z6 = np.zeros(6, np.float32)
    R0 = np.asarray(jlie.so3_exp(jnp.asarray([0.1, -0.2, 0.05], jnp.float32)))

    def t_fn(xi):
        R, t = lie.se3_exp(xi)
        return torch.cat([lie.so3_log(R @ T(R0)), t])

    def j_fn(xi):
        R, t = jlie.se3_exp(xi)
        return jnp.concatenate([jlie.so3_log(R @ jnp.asarray(R0)), t])

    got = torch.func.jacfwd(t_fn)(T(z6))
    ref = jax.jacfwd(j_fn)(jnp.asarray(z6))
    assert torch.isfinite(got).all()
    close(got, ref, atol=1e-5)
    got_id = torch.func.jacfwd(lambda x: lie.so3_log(lie.so3_exp(x)))(torch.zeros(3))
    close(got_id, np.eye(3), atol=1e-6)


def test_planes_match_jax():
    rng = np.random.default_rng(2)
    n_w, d_w = make_world(rng)
    R = rand_rotation(rng)
    t = (rng.normal(size=3) * 100).astype(np.float32)
    n_c, d_c = planes.transform_plane(T(R), T(t), T(n_w), T(d_w))
    jn, jd = jplanes.transform_plane(jnp.asarray(R), jnp.asarray(t), jnp.asarray(n_w),
                                     jnp.asarray(d_w))
    close(n_c, jn, atol=1e-6)
    close(d_c, jd, atol=1e-3, rtol=1e-6)
    n_b, d_b = planes.untransform_plane(T(R), T(t), n_c, d_c)
    close(n_b, n_w, atol=1e-5)
    close(d_b, d_w, atol=0, rtol=1e-5)
    eta = planes.to_cp(T(n_w), T(d_w))
    close(eta, jplanes.to_cp(jnp.asarray(n_w), jnp.asarray(d_w)), atol=0)
    eta0 = torch.cat([eta, torch.zeros(1, 3)])
    n2, d2 = planes.from_cp(eta0)
    jn2, jd2 = jplanes.from_cp(jnp.asarray(eta0.numpy()))
    close(n2, jn2, atol=1e-7)
    close(d2, jd2, atol=0, rtol=1e-6)
    assert n2[-1].tolist() == [0.0, 0.0, 1.0]


# ------------------------------------------------------ association, odometry

def _scene(seed, m=8, P=16, distractors=True):
    """A world of m landmarks seen from a pose prior: observations are the
    landmarks in the camera with noise, in shuffled slots, plus distractor
    planes that must stay unmatched."""
    rng = np.random.default_rng(seed)
    n_w, d_w = make_world(rng, m=m)
    R = rand_rotation(rng, 0.3)
    t = (rng.normal(size=3) * 50).astype(np.float32)
    n_c = n_w @ R.T
    d_c = d_w - n_c @ t
    n_obs = n_c + rng.normal(size=n_c.shape) * 0.01
    n_obs /= np.linalg.norm(n_obs, axis=1, keepdims=True)
    d_obs = d_c + rng.normal(size=m) * 20.0
    slots = rng.permutation(P)[:m]
    normal = np.zeros((P, 3), np.float32)
    d = np.zeros(P, np.float32)
    weight = np.zeros(P, np.float32)
    normal[slots], d[slots], weight[slots] = n_obs, d_obs, rng.uniform(50, 5000, m)
    if distractors:
        free = np.setdiff1d(np.arange(P), slots)[:3]
        dn, dd = make_world(rng, m=3)
        normal[free], d[free], weight[free] = dn, dd + 4000.0, 100.0
    mean = -d[:, None] * normal + rng.normal(size=(P, 3)) * 30.0
    obs = dict(normal=normal.astype(np.float32), d=d, weight=weight,
               mean=mean.astype(np.float32))
    return obs, n_w, d_w, R, t


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_association_matches_jax(seed):
    obs, n_w, d_w, R, t = _scene(seed)
    valid = np.ones(len(d_w), bool)
    valid[-1] = False                       # a free map slot never matches
    got = associate(plane_obs_from_numpy(obs), T(n_w), T(d_w), T(valid, torch.bool),
                    T(R), T(t))
    ref = jassociate(jplanes.PlaneObs(**{k: jnp.asarray(v) for k, v in obs.items()}),
                     jnp.asarray(n_w), jnp.asarray(d_w), jnp.asarray(valid),
                     jnp.asarray(R), jnp.asarray(t))
    np.testing.assert_array_equal(got.landmark.numpy(), np.asarray(ref.landmark))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert got.landmark.dtype == torch.int32 and int(got.valid.sum()) >= 5


def test_association_ties_go_to_the_first_index():
    """Two identical observations of one landmark: the first slot wins."""
    obs = dict(normal=np.array([[0, 0, 1.0], [0, 0, 1.0]], np.float32),
               d=np.array([1000.0, 1000.0], np.float32),
               weight=np.array([10.0, 10.0], np.float32),
               mean=np.array([[0, 0, -1000.0], [0, 0, -1000.0]], np.float32))
    m = associate(plane_obs_from_numpy(obs), T([[0, 0, 1.0]]), T([1000.0]),
                  torch.ones(1, dtype=torch.bool), torch.eye(3), torch.zeros(3))
    assert m.landmark.tolist() == [0, -1]


@pytest.mark.parametrize("seed", [5, 7])
def test_odometry_matches_jax_and_batches(seed):
    rng = np.random.default_rng(seed)
    n_w, d_w = make_world(rng, m=10)
    R_true = rand_rotation(rng, 0.2)
    t_true = (rng.normal(size=3) * 80).astype(np.float32)
    n_c = n_w @ R_true.T
    d_c = d_w - n_c @ t_true
    obs = dict(normal=n_c.astype(np.float32), d=d_c.astype(np.float32),
               weight=rng.uniform(20, 2000, 10).astype(np.float32),
               mean=(-d_c[:, None] * n_c).astype(np.float32))
    valid = np.ones(10, bool)
    valid[3] = False
    dR, dt = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(
        [0.05, -0.04, 0.03, 20.0, -15.0, 10.0], jnp.float32)))
    R0, t0 = dR @ R_true, dR @ t_true + dt
    got = estimate_pose(plane_obs_from_numpy(obs), T(n_w), T(d_w),
                        torch.arange(10), T(valid, torch.bool), T(R0), T(t0), iterations=10)
    ref = jestimate_pose(jplanes.PlaneObs(**{k: jnp.asarray(v) for k, v in obs.items()}),
                         jnp.asarray(n_w), jnp.asarray(d_w), jnp.arange(10),
                         jnp.asarray(valid), jnp.asarray(R0), jnp.asarray(t0), iterations=10)
    close(got.R, ref.R, atol=1e-5)
    close(got.t, ref.t, atol=2e-3)
    close(got.R, R_true, atol=1e-3)
    close(got.t, t_true, atol=1.0)
    assert int(got.num_inliers) == int(ref.num_inliers) == 9
    close(got.residual, ref.residual, atol=1e-3, rtol=1e-2)
    # Leading batch axes: each problem of a batch as if alone.
    stack = lambda x: torch.stack([x, x])                           # noqa: E731
    obs_b = plane_obs_from_numpy({k: np.stack([v, v]) for k, v in obs.items()})
    R0b = np.stack([R0, R_true])
    t0b = np.stack([t0, t_true])
    batched = estimate_pose(obs_b, stack(T(n_w)), stack(T(d_w)),
                            stack(torch.arange(10)), stack(T(valid, torch.bool)),
                            T(R0b), T(t0b), iterations=10)
    close(batched.R[0], got.R, atol=1e-6)
    close(batched.t[0], got.t, atol=1e-4)
    close(batched.t[1], t_true, atol=1.0)


# ------------------------------------------------------------------------- BA

def test_ba_jacobians_match_jax_jacfwd():
    rng = np.random.default_rng(6)
    f = perturbed(make_problem(rng, K=4, M=6, noise=0.01), rng)
    prob = ba_problem_from_numpy(f)
    r, Jp, Jl = ba._obs_terms(prob)
    rep = lambda x: np.repeat(x, 6, axis=0)                       # noqa: E731
    jr, jJp, jJl = (np.asarray(a).reshape(4, 6, *a.shape[1:]) for a in J_OBS_TERMS(
        jnp.asarray(rep(f["R"])), jnp.asarray(rep(f["t"])),
        jnp.asarray(f["eta"][f["obs_lm"].reshape(-1)]),
        jnp.asarray(f["obs_normal"].reshape(-1, 3)), jnp.asarray(f["obs_d"].reshape(-1))))
    close(r, jr, atol=2e-2, rtol=1e-5)
    close(Jp, jJp, atol=2e-2, rtol=1e-5)
    close(Jl, jJl, atol=1e-4, rtol=1e-5)
    close(ba._obs_residuals(prob), r, atol=2e-2, rtol=1e-5)


def test_prior_jacobians_match_jax_jacfwd():
    rng = np.random.default_rng(9)
    truth = make_problem(rng, K=5, M=6)
    f = with_priors(perturbed(truth, rng), rng, chain=truth)
    R, t = T(f["R"]), T(f["t"])
    Haa, Hab, Hbb, ga, gb, cost = ba._odo_blocks(R, t, T(f["odo_R"]), T(f["odo_t"]),
                                                 T(f["odo_w"]))
    ref = J_ODO_BLOCKS(jnp.asarray(f["R"]), jnp.asarray(f["t"]), jnp.asarray(f["odo_R"]),
                          jnp.asarray(f["odo_t"]), jnp.asarray(f["odo_w"]))
    for got, want in zip((Haa, Hab, Hbb, ga, gb, cost), ref):
        close(got, want, atol=0, rtol=2e-3) if got.dim() == 0 else \
            close(got, want, atol=1e-3 * float(np.abs(np.asarray(want)).max()) + 1e-3)
    J, r, cv_cost = ba._cv_blocks(R, t, T(f["cv_w"]))
    jJ, jr, jcost = J_CV_BLOCKS(jnp.asarray(f["R"]), jnp.asarray(f["t"]),
                                   jnp.asarray(f["cv_w"]))
    close(J, jJ, atol=1e-2, rtol=1e-4)
    close(r, jr, atol=2e-2, rtol=1e-4)
    close(cv_cost, jcost, atol=1e-2, rtol=2e-3)


@pytest.mark.parametrize("priors", [False, True], ids=["plain", "priors"])
def test_ba_step_and_cost_match_jax(priors):
    rng = np.random.default_rng(7)
    f = perturbed(make_problem(rng, K=6, M=10, noise=0.005), rng)
    if priors:
        f = with_priors(f, rng)
    got = ba.ba_step(ba_problem_from_numpy(f), damping=1e-4)
    ref = J_BA_STEP(jax_problem(f))
    got64 = ba.ba_step(to_f64(ba_problem_from_numpy(f)), damping=1e-4)
    with jax.enable_x64(True):
        ref64 = J_BA_STEP(jax_problem(f64_fields(f)))
    held_to_jax(got, got64, ref, ref64, ("R", "t", "eta"))
    close(got.cost, ref.cost, atol=1e-2, rtol=1e-3)
    close(ba.ba_cost(ba_problem_from_numpy(f)), J_BA_COST(jax_problem(f)),
          atol=1e-2, rtol=1e-3)


def test_run_ba_matches_jax_and_recovers_truth():
    rng = np.random.default_rng(7)
    truth = make_problem(rng, K=5, M=10)
    f = perturbed(truth, rng)
    got = ba.run_ba(ba_problem_from_numpy(f), iterations=15, damping=1e-6)
    ref = J_RUN_BA(jax_problem(f), iterations=15, damping=1e-6)
    close(got.R, ref.R, atol=1e-4)
    close(got.t, ref.t, atol=0.05)
    close(got.eta, ref.eta, atol=0.05, rtol=1e-5)
    close(got.R, truth["R"], atol=5e-3)
    close(got.t, truth["t"], atol=2.0)
    assert float(got.cost) < 1e-2 and float(ref.cost) < 1e-2


def test_run_ba_with_priors_matches_jax():
    rng = np.random.default_rng(13)
    f = with_priors(perturbed(make_problem(rng, K=6, M=8, noise=0.01), rng), rng)
    got = ba.run_ba(ba_problem_from_numpy(f), iterations=6)
    ref = J_RUN_BA(jax_problem(f), iterations=6)
    close(got.R, ref.R, atol=5e-4)
    close(got.t, ref.t, atol=0.2, rtol=1e-3)
    close(got.cost, ref.cost, atol=1.0, rtol=1e-2)
    assert float(got.cost) <= float(ba.ba_cost(ba_problem_from_numpy(f)))


def test_pad_problem_keyframes_matches_jax_and_is_inert():
    rng = np.random.default_rng(8)
    f = with_priors(make_problem(rng, K=5, M=6), rng)
    got = ba.pad_problem_keyframes(ba_problem_from_numpy(f), 8)
    ref = jba.pad_problem_keyframes(jax_problem(f), 8)
    for name in got._fields:
        close(getattr(got, name), getattr(ref, name), atol=0)
    # Inert: in float64 the padded step equals the unpadded one.
    step = ba.ba_step(to_f64(got))
    base = ba.ba_step(to_f64(ba_problem_from_numpy(f)))
    close(step.R[:5], base.R, atol=1e-9)
    close(step.t[:5], base.t, atol=1e-7)
    close(step.R[5:], np.broadcast_to(np.eye(3), (3, 3, 3)), atol=0)
    with pytest.raises(ValueError):
        ba.pad_problem_keyframes(got, 4)


# ----------------------------------------------------------------- pose graph

def _chain(seed, K=6, cv=False):
    """A perturbed pose chain with exact relative edges and one loop closure
    (tests/test_slam.py TestPoseGraph); numpy fields."""
    rng = np.random.default_rng(seed)
    Rs = [np.eye(3, dtype=np.float32)] + [rand_rotation(rng, 0.1) for _ in range(K - 1)]
    ts = [np.zeros(3, np.float32)] + [(rng.normal(size=3) * 40).astype(np.float32)
                                      for _ in range(K - 1)]
    R, t = np.stack(Rs).astype(np.float32), np.stack(ts)
    edges = [(k, k + 1) for k in range(K - 1)] + [(0, K - 1)]
    mR = np.stack([R[a].T @ R[b] for a, b in edges]).astype(np.float32)
    mt = np.stack([R[a].T @ (t[b] - t[a]) for a, b in edges]).astype(np.float32)
    xi = rng.normal(size=(K, 6)).astype(np.float32) * np.array([0.03] * 3 + [8.0] * 3,
                                                                np.float32)
    xi[0] = 0.0
    dR, dt = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(xi)))
    fields = dict(R=np.einsum("kij,kjl->kil", dR, R).astype(np.float32),
                  t=(np.einsum("kij,kj->ki", dR, t) + dt).astype(np.float32),
                  edge_a=np.array([a for a, _ in edges], np.int32),
                  edge_b=np.array([b for _, b in edges], np.int32),
                  meas_R=mR, meas_t=mt,
                  weight=rng.uniform(0.5, 2.0, len(edges)).astype(np.float32),
                  cv_w=np.full(K - 2, 100.0, np.float32) if cv else None)
    return fields, R, t


def jax_graph(fields):
    return jpg.PoseGraph(**{k: None if v is None else jnp.asarray(v)
                            for k, v in fields.items()})


@pytest.mark.parametrize("cv", [False, True], ids=["edges", "cv"])
def test_pose_graph_step_matches_jax(cv):
    f, _, _ = _chain(9, cv=cv)
    got = pose_graph.pose_graph_step(pose_graph_from_numpy(f))
    ref = J_PG_STEP(jax_graph(f))
    got64 = pose_graph.pose_graph_step(to_f64(pose_graph_from_numpy(f)))
    with jax.enable_x64(True):
        ref64 = J_PG_STEP(jax_graph(f64_fields(f)))
    held_to_jax(got, got64, ref, ref64, ("R", "t"))
    close(pose_graph.graph_cost(pose_graph_from_numpy(f)), J_GRAPH_COST(jax_graph(f)),
          atol=1e-2, rtol=1e-4)


def test_optimize_pose_graph_matches_jax_and_closes_the_loop():
    f, R, t = _chain(9, cv=False)
    g = pose_graph_from_numpy(f)
    got = pose_graph.optimize_pose_graph(g, iterations=40)
    ref = J_OPTIMIZE_PG(jax_graph(f), iterations=40)
    close(got.R, ref.R, atol=1e-4)
    close(got.t, ref.t, atol=0.05)
    assert float(pose_graph.graph_cost(got)) < 1e-3 * float(pose_graph.graph_cost(g))
    close(got.R, R, atol=1e-2)
    close(got.t, t, atol=2.0)


# ----------------------------------------------------------------- checkpoint

def _jax_state():
    from deplex_tpu.slam import init_map as jinit_map

    m = jinit_map(16)
    m = m._replace(d=m.d + 5.0, weight=m.weight.at[:3].set(7.0), count=jnp.int32(3))
    rng = np.random.default_rng(1)
    return {"map": m, "R": jnp.asarray(rand_rotation(rng)),
            "t": jnp.asarray(rng.normal(size=3).astype(np.float32)),
            "kf_lm": jnp.asarray(rng.integers(-1, 16, (4, 8)).astype(np.int32))}


@pytest.fixture
def jax_npz_checkpoints(monkeypatch):
    """The reference package's checkpoint module, forced to its npz form
    (orbax is installed here, and it would write a directory instead)."""
    from deplex_tpu.slam import checkpoint as jck

    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    return jck


def test_checkpoint_jax_to_torch(tmp_path, jax_npz_checkpoints):
    from deplex_tpu_torch.slam import MapState
    from deplex_tpu_torch.slam.checkpoint import load_checkpoint

    state = _jax_state()
    jax_npz_checkpoints.save_checkpoint(str(tmp_path / "ck"), state)
    assert (tmp_path / "ck.npz").exists()
    example = {"map": MapState(*(np.zeros_like(np.asarray(x)) for x in state["map"])),
               "R": np.zeros((3, 3)), "t": np.zeros(3), "kf_lm": np.zeros((4, 8))}
    got = load_checkpoint(str(tmp_path / "ck"), example)
    assert isinstance(got["map"], MapState)
    for a, b in zip(got["map"], state["map"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    for k in ("R", "t", "kf_lm"):
        np.testing.assert_array_equal(got[k], np.asarray(state[k]))


def test_checkpoint_torch_to_jax(tmp_path, jax_npz_checkpoints):
    from deplex_tpu_torch.slam import MapState
    from deplex_tpu_torch.slam.checkpoint import save_checkpoint

    ref = _jax_state()
    ours = {"map": MapState(*(torch.as_tensor(np.asarray(x)) for x in ref["map"])),
            "R": torch.as_tensor(np.asarray(ref["R"])), "t": np.asarray(ref["t"]),
            "kf_lm": torch.as_tensor(np.asarray(ref["kf_lm"]))}
    save_checkpoint(str(tmp_path / "ck"), ours)
    got = jax_npz_checkpoints.load_checkpoint(str(tmp_path / "ck"), ref)
    for a, b in zip(got["map"], ref["map"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for k in ("R", "t", "kf_lm"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))
    # Both packages write the same leaves in the same order, and the same text.
    jax_npz_checkpoints.save_checkpoint(str(tmp_path / "jx"), ref)
    a, b = np.load(tmp_path / "ck.npz"), np.load(tmp_path / "jx.npz")
    assert int(a["n"]) == int(b["n"]) == 7
    for i in range(7):
        np.testing.assert_array_equal(a[f"leaf_{i}"], b[f"leaf_{i}"])
    assert a["treedef"].tobytes() == b["treedef"].tobytes()


def test_interop_keeps_absent_priors_none():
    rng = np.random.default_rng(3)
    f = make_problem(rng, K=3, M=4)
    prob = ba_problem_from_numpy(f)
    assert prob.odo_R is None and prob.cv_w is None and prob.obs_lm.dtype == torch.int64
    assert fields_of(jax_problem(f))["odo_R"] is None
    with pytest.raises(KeyError):
        ba_problem_from_numpy({"R": f["R"]})

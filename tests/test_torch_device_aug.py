"""The port's device augmentation (``data/device_aug.py``) against the JAX
package's, on the CPU.

Per op: the port's ``device_apply_op`` must equal JAX's ``device_apply_op``
(and the native backend's ``apply_op_native``, itself bit-exact with PIL)
uint8 for uint8 at the same (op, magnitude, sign), on an RGB and a
grayscale image.  Mirror, pad+crop, cutout and the composed geometric
prefix must equal JAX's at the same parameters, and the whole
``DeviceTransform`` must equal JAX's when given the parameters JAX drew.
The random streams differ by design (``torch.Generator`` against
``jax.random``), so the port's own draws are checked for determinism, for
per-image independence and for covering every op class.  Both sides
compute coordinates in float64 (JAX under the shared conftest's x64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu.data import device_aug as D
from graphlearninglayer_tpu_torch.data import device_aug as T
from graphlearninglayer_tpu_torch.data import native as N


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU ops are tiny: one thread runs them faster, and the suite's
    parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images():
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, (32, 32, 3), np.uint8)
    # a limited-range channel exercises autocontrast's lo / hi
    rgb[..., 1] = 40 + (rgb[..., 1] % 150)
    gray = rng.integers(0, 256, (28, 28, 1), np.uint8)
    return {"rgb": rgb, "gray": gray}


def _op_grid():
    """(op, v, sign) at four magnitudes across each op's range."""
    grid = []
    for op in range(14):
        lo, hi = float(D._OP_LO[op]), float(D._OP_HI[op])
        for frac in (0.0, 0.33, 0.77, 1.0):
            for sign in (False, True):
                grid.append((op, lo + frac * (hi - lo), sign))
    return grid


@pytest.fixture(scope="module")
def jax_ops():
    """JAX's device_apply_op over the whole grid, one compiled program per
    image shape."""
    grid = _op_grid()
    ops, vs, signs = (jnp.asarray(a) for a in zip(*grid))
    run = jax.jit(jax.vmap(D.device_apply_op, in_axes=(None, 0, 0, 0)))
    return grid, {name: np.asarray(run(img, ops, vs, signs))
                  for name, img in _images().items()}


@pytest.mark.parametrize("op", sorted(T.OP_IDS))
def test_op_matches_jax_and_native(op, jax_ops):
    grid, want = jax_ops
    op_id = T.OP_IDS[op]
    assert op_id == D.OP_IDS[op] == N.OP_IDS[op]
    native = N.native_available()
    for name, img in _images().items():
        for i, (o, v, sign) in enumerate(grid):
            if o != op_id:
                continue
            got = T.device_apply_op(img, o, v, sign)
            assert got.dtype == torch.uint8 and got.shape == img.shape
            msg = f"{op} v={v} sign={sign} {name}"
            np.testing.assert_array_equal(got.numpy(), want[name][i],
                                          err_msg=msg)
            if native:
                np.testing.assert_array_equal(
                    got.numpy(), N.apply_op_native(img, o, v, sign),
                    err_msg=msg)


def test_mirror_pad_crop_cutout_match_jax_and_native():
    native = N.native_available()
    # JAX's ops compiled: op by op they take seconds on the CPU
    jax_pad_crop = jax.jit(D.device_pad_crop, static_argnums=(1, 2))
    jax_cutout = jax.jit(D.device_cutout)
    for name, img in _images().items():
        got = T.device_mirror(img).numpy()
        np.testing.assert_array_equal(got, np.asarray(D.device_mirror(img)))
        if native:
            np.testing.assert_array_equal(got, N.mirror_native(img))
        for pad, reflect in ((4, False), (4, True), (8, True)):
            for i, j in ((0, 0), (3, 7), (2 * pad, 2 * pad)):
                msg = f"{name} pad={pad} {reflect} {i} {j}"
                got = T.device_pad_crop(img, pad, reflect, i, j).numpy()
                np.testing.assert_array_equal(
                    got,
                    np.asarray(jax_pad_crop(img, pad, reflect, i, j)),
                    err_msg=msg)
                if native:
                    np.testing.assert_array_equal(
                        got, N.pad_crop_native(img, pad, reflect, i, j),
                        err_msg=msg)
        for frac, r1, r2 in ((0.4, 0.3, 0.6), (0.49, 0.99, 0.01),
                             (0.2, 0.0, 1.0), (0.5, 0.5, 0.5),
                             (0.0, 0.5, 0.5)):
            msg = f"{name} cutout {frac} {r1} {r2}"
            got = T.device_cutout(img, frac, r1, r2).numpy()
            np.testing.assert_array_equal(
                got, np.asarray(jax_cutout(img, frac, r1, r2)),
                err_msg=msg)
            if native:
                np.testing.assert_array_equal(
                    got, N.cutout_native(img, frac, r1, r2), err_msg=msg)


def test_prefix_matches_jax_and_sequential_ops():
    """The composed rotate -> flip -> pad+crop resample equals JAX's and
    the three single-op resamples in sequence (the port's and the native
    backend's), over random configurations of both pad modes, flip,
    rotation and channel counts."""
    rng = np.random.default_rng(3)
    for trial in range(16):
        c = int(rng.integers(0, 2)) * 2 + 1
        h = w = int(rng.choice([28, 32]))
        img = rng.integers(0, 256, (h, w, c), np.uint8)
        rotation = int(rng.choice([0, 10, 20]))
        flip, do_flip = bool(rng.integers(0, 2)), bool(rng.integers(0, 2))
        pad = int(rng.choice([0, 4, 8]))
        reflect = bool(rng.integers(0, 2))
        ang = float((rng.random() * 2 - 1) * rotation)
        i, j = (int(a) for a in rng.integers(0, 2 * pad + 1, 2))
        if not (rotation or flip or pad):
            continue
        cfg = dict(rotation=rotation, flip=flip, pad=pad,
                   pad_reflect=reflect)
        msg = f"trial {trial}: {cfg} ang={ang} do_flip={do_flip} {i} {j}"

        x = D._to_planar(jnp.asarray(img)[None])
        src, valid = D._prefix_src(
            h, w, 1, jnp.asarray([ang], jnp.float64),
            jnp.asarray([do_flip]), jnp.asarray([[i, j]], jnp.int32), **cfg)
        want = np.asarray(D._from_planar(D._warp(x, src, valid), h, w)[0])

        src, valid = T._prefix_src(
            h, w, 1, torch.tensor([ang], dtype=torch.float64),
            torch.tensor([do_flip]), torch.tensor([[i, j]]), device="cpu",
            **cfg)
        x = T._to_planar(torch.from_numpy(img)[None])
        got = T._from_planar(T._warp(x, src, valid), h, w)[0]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=msg)

        seq, nat = torch.from_numpy(img), img
        native = N.native_available()
        if rotation:
            seq = T.device_rotate(seq, ang)
            nat = N.rotate_native(nat, ang) if native else nat
        if flip and do_flip:
            seq = T.device_mirror(seq)
            nat = N.mirror_native(nat) if native else nat
        if pad:
            seq = T.device_pad_crop(seq, pad, reflect, i, j)
            nat = N.pad_crop_native(nat, pad, reflect, i, j) if native \
                else nat
        np.testing.assert_array_equal(seq.numpy(), want, err_msg=msg)
        if native:
            np.testing.assert_array_equal(nat, want, err_msg=msg)


def _jax_transform_and_params(tf, batch, key):
    """JAX's DeviceTransform output and the parameters it drew: the draws
    of ``DeviceTransform.__call__``, made again from the same keys."""
    f64 = jnp.float64

    def run(batch, key):
        n = batch.shape[0]
        per_img = jax.random.split(key, n)
        keys = jax.vmap(lambda k: jax.random.split(k, 4 + tf.rand_n))(
            per_img)
        draw = lambda ks, fn: jax.vmap(fn)(ks)
        params = {}
        if tf.rotation > 0:
            u = draw(keys[:, 0], lambda k: jax.random.uniform(k, (), f64))
            params["ang"] = (u * 2.0 - 1.0) * tf.rotation
        params["do_flip"] = draw(
            keys[:, 1], lambda k: jax.random.uniform(k, ())) < 0.5
        if tf.pad > 0:
            params["off"] = draw(keys[:, 2], lambda k: jax.random.randint(
                k, (2,), 0, 2 * tf.pad + 1))
        rounds = []
        for t in range(tf.rand_n):
            rk = jax.vmap(lambda k: jax.random.split(k, 3))(keys[:, 4 + t])
            op = draw(rk[:, 0], lambda k: jax.random.randint(k, (), 0, 14))
            u = draw(rk[:, 1], lambda k: jax.random.uniform(k, (), f64))
            neg = draw(rk[:, 2], lambda k: jax.random.uniform(k, ())) > 0.5
            lo = jnp.take(jnp.asarray(D._OP_LO), op).astype(f64)
            hi = jnp.take(jnp.asarray(D._OP_HI), op).astype(f64)
            v = u * (hi - lo) + lo
            sv = jnp.where(jnp.take(jnp.asarray(D._OP_SIGNED), op) & neg,
                           -v, v)
            rounds.append((op, v, sv))
        params["rounds"] = rounds
        ucut = draw(keys[:, 3], lambda k: jax.random.uniform(k, (3,), f64))
        params["cutout"] = (ucut[:, 0] * 0.5, ucut[:, 1], ucut[:, 2])
        return tf(batch, key), params

    out, params = jax.jit(run)(jnp.asarray(batch), key)
    to_t = lambda a: torch.from_numpy(np.asarray(a).copy())
    return np.asarray(out), jax.tree_util.tree_map(to_t, params)


@pytest.mark.parametrize("dataset,mode", [("cifar10", "weak"),
                                          ("cifar10", "strong"),
                                          ("mnist", "strong")])
def test_transform_given_jax_params_matches_jax(dataset, mode):
    shape = (32, 32, 3) if dataset == "cifar10" else (28, 28, 1)
    batch = np.random.default_rng(5).integers(0, 256, (8, *shape), np.uint8)
    want, params = _jax_transform_and_params(
        D.DeviceTransform(dataset, mode), batch, jax.random.PRNGKey(2))
    tf = T.DeviceTransform(dataset, mode)
    assert (tf.rand_n, tf.rotation, tf.flip, tf.pad, tf.pad_reflect) == \
        (2 if mode == "strong" else 1, 20 if dataset == "mnist" else 0,
         dataset == "cifar10", 4, dataset == "cifar10")
    got = tf.apply(torch.from_numpy(batch), params)
    assert got.dtype == torch.uint8 and got.shape == batch.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, batch)


def test_eval_identity_seeded_draws_and_independent_rows():
    batch = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (8, 32, 32, 3), np.uint8))
    ev = T.DeviceTransform("cifar10", "eval")
    assert ev.is_eval and ev(batch, torch.Generator()) is batch
    for mode in ("weak", "strong"):
        tf = T.DeviceTransform("cifar10", mode)
        gen = lambda s: torch.Generator().manual_seed(s)
        out = tf(batch, gen(0))
        assert out.shape == batch.shape and out.dtype == torch.uint8
        assert torch.equal(out, tf(batch, gen(0)))
        assert not torch.equal(out, tf(batch, gen(1)))
        # per-image draws: identical rows augment differently
        same = batch[:1].expand(8, -1, -1, -1).contiguous()
        outs = tf(same, gen(0))
        assert len({o.numpy().tobytes() for o in outs}) > 1


def test_every_op_class_appears_over_a_round():
    params = T.DeviceTransform("mnist", "strong").draw(
        256, torch.Generator().manual_seed(0))
    assert set(params) == {"ang", "off", "rounds", "cutout"}
    for op, v, sv in params["rounds"]:
        assert set(op.tolist()) == set(range(14))
        lo = torch.from_numpy(T._OP_LO).double()[op]
        hi = torch.from_numpy(T._OP_HI).double()[op]
        assert bool(((v >= lo) & (v <= hi)).all())
        signed = torch.from_numpy(T._OP_SIGNED)[op]
        assert bool((sv[~signed] == v[~signed]).all())
        assert bool((sv[signed] < 0).any() and (sv[signed] > 0).any())
    assert params["ang"].abs().max() <= 20
    assert int(params["off"].min()) == 0 and int(params["off"].max()) == 8

"""The asset trainers of the port (OrderFormer training in
models/orderformer.py, train/detector_train.py, and their command lines under
callireader_tpu_torch/scripts/) against the JAX package on the CPU at small
sizes.

Tolerances: the schedules equal optax's at every step within 1e-6 relative
or two float32 ulps of the peak rate (the port computes them in float64,
optax in float32, whose 1 + cos(x) near the end of a period keeps ~2^-23 of
the peak); the synthetic data is byte-equal (both are numpy RandomState);
after 3 OrderFormer and 2 detector steps from the same parameters and
batches the parameters are within 1e-5 relative (L2 over the whole tree) of
JAX's and each leaf within 1e-4 (AdamW divides a gradient by its own size
plus eps = 1e-8, which turns the packages' summation-order differences in
small gradients into larger differences of the update), each step's loss
within 1e-5. The OrderFormer's key biases are left out of the parameter
comparison: their gradient is zero in exact arithmetic (softmax ignores a
constant added to every key's score), so both packages move them by AdamW's
normalisation of their own rounding noise; the trained models' outputs are
held within 1e-5 instead. ``evaluate_orderformer`` and ``detection_recall``
give JAX's numbers; ``save_npz`` files load in either package to the same
fp16-rounded leaves.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from callireader_tpu.core.config import DetectorConfig as JDetCfg
from callireader_tpu.core.config import OrderFormerConfig as JOfCfg
from callireader_tpu.models import detector as jdet
from callireader_tpu.models import orderformer as jof
from callireader_tpu.train import detector_train as jdt
from callireader_tpu_torch.core.config import DetectorConfig as TDetCfg
from callireader_tpu_torch.core.config import OrderFormerConfig as TOfCfg
from callireader_tpu_torch.models import detector as tdet
from callireader_tpu_torch.models import orderformer as tof
from callireader_tpu_torch.runtime.weights import from_jax_params
from callireader_tpu_torch.scripts import train_detector as tscript_det
from callireader_tpu_torch.scripts import train_orderformer as tscript_of
from callireader_tpu_torch.train import detector_train as tdt
from callireader_tpu_torch.train import e_it

REPO = Path(__file__).resolve().parents[1]
REL = 1e-5
OF_SMALL = dict(model_dim=32, num_layers=2, num_heads=4, ff_dim=64)
DET_SIZE = 64


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _assert_trees_close(got, want, leaf_rel=1e-4, skip=lambda key, a: a):
    """The whole tree within REL and each leaf within ``leaf_rel`` (rel L2);
    ``skip(key, array)`` returns the part of a leaf to compare."""
    wflat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    gflat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(gflat) == set(wflat)
    g_all, w_all = [], []
    for k, w in wflat.items():
        g, w = skip(k, gflat[k].detach().numpy()), skip(k, np.asarray(w))
        assert _rel(g, w) <= leaf_rel, k
        g_all.append(g.ravel())
        w_all.append(w.ravel())
    assert _rel(np.concatenate(g_all), np.concatenate(w_all)) <= REL


def _no_key_bias(key, a):
    """An OrderFormer leaf without the key third of in_proj_bias."""
    if "in_proj_bias" in jax.tree_util.keystr(key):
        E = a.shape[-1] // 3
        return np.concatenate([a[..., :E], a[..., 2 * E:]], axis=-1)
    return a


# ------------------------------------------------------------------ schedules


def _optax_restarts(lr, t0, t_mult, total):
    schedules, boundaries, t, pos = [], [], t0, 0
    while pos < total:
        schedules.append(optax.cosine_decay_schedule(lr, t, alpha=1e-6 / lr))
        pos += t
        boundaries.append(pos)
        t *= t_mult
    return optax.join_schedules(schedules, boundaries[:-1])


@pytest.mark.parametrize("lr,t0,t_mult,total", [(2e-4, 10, 2, 1000), (1e-3, 1, 2, 6),
                                                (5e-4, 3, 3, 40)])
def test_orderformer_schedule_equals_optax(lr, t0, t_mult, total):
    got, want = tof.warm_restarts(lr, t0, t_mult, total), _optax_restarts(lr, t0, t_mult, total)
    for count in range(total + 5):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=2 ** -22 * lr)


@pytest.mark.parametrize("total,warmup", [(500, 20), (10, 20), (3, 1)])
def test_detector_schedule_equals_optax(total, warmup):
    tc = tdt.DetTrainConfig(total_steps=total, warmup=warmup, learning_rate=2e-3)
    w = min(warmup, max(1, total // 5))
    want = optax.warmup_cosine_decay_schedule(0.0, 2e-3, w, total)
    got = tdt.make_optimizer(tc).schedule
    for count in range(total + 5):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=2 ** -22 * 2e-3)


# ------------------------------------------------------------------ synthetic data


def test_synthetic_data_is_byte_equal():
    jscript = _jax_script("train_orderformer")
    jb = jscript.build_dataset(JOfCfg(), 24, 3)
    tb = tscript_of.build_dataset(TOfCfg(), 24, 3)
    for a, b in zip(tb, jb):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for gen, args in ((lambda m, r: m.synth_pages(r, 2, 96, 12), ()),
                      (lambda m, r: m.make_glyph_bank(r, 5, 24), ()),
                      (lambda m, r: m.synth_calligraphy_pages(
                          r, 2, 128, 32, m.make_glyph_bank(r, 6, 24)), ())):
        for a, b in zip(gen(tdt, np.random.RandomState(5)), gen(jdt, np.random.RandomState(5))):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    a, b = [tscript_of.kendall_tau(np.array(x, float), np.array([3., 1, 2, 4])) for x in
            ([1, 2, 3, 4], [3, 1, 2, 4])]
    assert (a, b) == (jscript.kendall_tau(np.array([1., 2, 3, 4]), np.array([3., 1, 2, 4])), 1.0)


# ------------------------------------------------------------------ OrderFormer


@pytest.fixture(scope="module")
def of_case():
    jcfg, tcfg = JOfCfg(**OF_SMALL), TOfCfg(**OF_SMALL)
    boxes, ranks, counts = tscript_of.build_dataset(tcfg, 16, 1)
    return jcfg, tcfg, jof.init_params(jax.random.PRNGKey(0), jcfg), boxes, ranks, counts


def test_orderformer_steps_equal_jax(of_case):
    jcfg, tcfg, jparams, boxes, ranks, _ = of_case
    kw = dict(lr=1e-3, weight_decay=0.01, t0=1, t_mult=2, total_steps=6)
    jstep, jtx = jof.make_train_step(jcfg, **kw)
    tstep, ttx = tof.make_train_step(tcfg, **kw)
    jopt = jtx.init(jparams)
    tparams = e_it.clone_tree(_t(jparams), True)
    topt = ttx.init(e_it.flatten(tparams))
    for i in range(3):
        sl = slice(4 * i, 4 * i + 4)
        jparams, jopt, jl = jstep(jparams, jopt, jnp.asarray(boxes[sl]), jnp.asarray(ranks[sl]))
        tparams, topt, tl = tstep(tparams, topt, torch.from_numpy(boxes[sl]),
                                  torch.from_numpy(ranks[sl]))
        assert abs(float(tl) - float(jl)) <= REL * float(jl)
    _assert_trees_close(tparams, jparams, skip=_no_key_bias)
    assert topt["count"] == 3
    want = jof.forward(jparams, jcfg, jnp.asarray(boxes))
    with torch.no_grad():
        assert _rel(tof.forward(tparams, tcfg, torch.from_numpy(boxes)).numpy(), want) <= REL


def test_train_and_evaluate_orderformer_equal_jax(of_case):
    jcfg, tcfg, jparams, boxes, ranks, counts = of_case
    kw = dict(batch_size=4, lr=1e-3, epochs=2, seed=2)
    jbest, jloss = jof.train_orderformer(jparams, jcfg, boxes, ranks, **kw)
    tstart = _t(jparams)
    tbest, tloss = tof.train_orderformer(tstart, tcfg, boxes, ranks, **kw)
    assert abs(tloss - jloss) <= REL * jloss
    _assert_trees_close(tbest, jbest, skip=_no_key_bias)
    assert torch.equal(tstart["embed_kernel"], _t(jparams)["embed_kernel"])  # the caller's tree
    assert not tbest["embed_kernel"].requires_grad
    want = jof.evaluate_orderformer(jbest, jcfg, boxes, ranks, counts)
    got = tof.evaluate_orderformer(tbest, tcfg, boxes, ranks, counts)
    assert got["order_accuracy"] == want["order_accuracy"]
    assert abs(got["loss"] - want["loss"]) <= REL * want["loss"]


def test_orderformer_init_holds_the_jax_tree_and_bounds():
    cfg = TOfCfg(**OF_SMALL)
    got = tof.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = jof.init_params(jax.random.PRNGKey(0), JOfCfg(**OF_SMALL))
    for (path, w), (_, g) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                 jax.tree_util.tree_flatten_with_path(got)[0]):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, path
        w, g = np.asarray(w), g.numpy()
        if "kernel" in str(path[-1]):
            # the same Glorot bound: both draws fill it to within 10%
            assert np.abs(g).max() <= np.abs(w).max() / 0.9 and np.abs(g).max() >= 0.9 * np.abs(w).max()
        else:
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ detector


@pytest.fixture(scope="module")
def det_case():
    jcfg, tcfg = JDetCfg(img_size=DET_SIZE), TDetCfg(img_size=DET_SIZE)
    rng = np.random.RandomState(0)
    imgs, gt, mask = tdt.synth_calligraphy_pages(rng, 4, DET_SIZE, 16,
                                                 tdt.make_glyph_bank(rng, 4, 16))
    # the starting tree drawn by the port (JAX's eager init of ~60 conv
    # shapes costs seconds a shape) and carried to JAX as numpy
    start = tdet.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    return jcfg, tcfg, jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), start), imgs, gt, mask


def test_detector_steps_equal_jax(det_case):
    jcfg, tcfg, jparams, imgs, gt, mask = det_case
    jtc, ttc = jdt.DetTrainConfig(total_steps=10), tdt.DetTrainConfig(total_steps=10)
    jtx, ttx = jdt.make_optimizer(jtc), tdt.make_optimizer(ttc)
    jstep = jax.jit(jdt.make_train_step(jcfg, jtc, jtx))
    tstep = tdt.make_train_step(tcfg, ttc, ttx)
    jopt = jtx.init(jparams)
    tparams = e_it.clone_tree(_t(jparams), True)
    topt = ttx.init(e_it.flatten(tparams))
    for i in range(2):
        sl = slice(2 * i, 2 * i + 2)
        jparams, jopt, jm = jstep(jparams, jopt, jnp.asarray(imgs[sl]), jnp.asarray(gt[sl]),
                                  jnp.asarray(mask[sl]))
        tparams, topt, tm = tstep(tparams, topt, torch.from_numpy(imgs[sl]),
                                  torch.from_numpy(gt[sl]), torch.from_numpy(mask[sl]))
        assert int(tm["n_pos"]) == int(jm["n_pos"]) > 0
        for k in ("loss", "cls", "box"):
            assert abs(float(tm[k]) - float(jm[k])) <= REL * abs(float(jm[k])), (i, k)
    _assert_trees_close(tparams, jparams)


def test_detection_recall_and_forward_raw_equal_jax(det_case):
    jcfg, tcfg, jparams, imgs, _, _ = det_case
    tparams = _t(jparams)
    raw_j = jdet.forward_raw(jparams, jcfg, jnp.asarray(imgs[:2]))
    raw_t = tdet.forward_raw(tparams, tcfg, torch.from_numpy(imgs[:2]))
    for (jb, jc, js), (tb, tc, ts) in zip(raw_j, raw_t):
        assert js == ts and _rel(tb.numpy(), jb) <= REL and _rel(tc.numpy(), jc) <= REL
    # recall of the committed trained detector on synthetic pages at 320
    # (a random one finds nothing to match)
    asset = jdet.load_npz(str(REPO / "callireader_tpu" / "assets" / "detector_640.npz"))
    rng = np.random.RandomState(0)
    pages, pgt, pmask = tdt.synth_calligraphy_pages(rng, 2, 320, 64, tdt.make_glyph_bank(rng, 8, 24))
    recalls = []
    for i in range(2):
        page = pages[i].astype(np.float32) / 255.0
        want = jdt.detection_recall(asset, JDetCfg(img_size=320), page, pgt[i][pmask[i]])
        got = tdt.detection_recall(_t(asset), TDetCfg(img_size=320), page, pgt[i][pmask[i]])
        assert got == want
        recalls.append(got)
    assert max(recalls) > 0.2


def test_detector_init_holds_the_jax_tree_and_bounds():
    cfg = TDetCfg(img_size=DET_SIZE)
    got = tdet.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.eval_shape(lambda k: jdet.init_params(k, JDetCfg(img_size=DET_SIZE)),
                          jax.random.PRNGKey(0))
    wflat, wdef = jax.tree_util.tree_flatten(want)
    gflat, gdef = jax.tree_util.tree_flatten(got)
    assert gdef == wdef
    for g, w in zip(gflat, wflat):
        assert tuple(g.shape) == w.shape and w.dtype == np.float32 and g.dtype == torch.float32
        if g.ndim == 4:  # JAX's _conv_init bound, 1 / sqrt(cin k k), nearly filled
            bound = 1 / np.sqrt(np.prod(w.shape[:3]))
            assert 0.9 * bound <= float(g.abs().max()) <= bound
        else:
            assert not g.any()
    assert tdet.channels(cfg) == jdet.channels(JDetCfg())
    assert [tdet._ch(b, 0.25, 1024) for b in (64, 100, 4096)] == \
        [jdet._ch(b, 0.25, 1024) for b in (64, 100, 4096)]


def test_save_npz_crosses_both_ways(det_case, tmp_path):
    _, tcfg, jparams, imgs, _, _ = det_case
    tparams = _t(jparams)
    jdet.save_npz(str(tmp_path / "j.npz"), jax.device_get(jparams))
    tdet.save_npz(str(tmp_path / "t.npz"), e_it.clone_tree(tparams, True))
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float16 and np.array_equal(a[k], b[k]), k
    rounded = jax.tree_util.tree_map(lambda x: np.asarray(x).astype(np.float16).astype(np.float32),
                                     jparams)
    for loaded in (tdet.load_npz(str(tmp_path / "j.npz"), "cpu"),
                   tdet.load_npz(str(tmp_path / "t.npz"), "cpu")):
        for (path, w), (_, g) in zip(jax.tree_util.tree_flatten_with_path(rounded)[0],
                                     jax.tree_util.tree_flatten_with_path(loaded)[0]):
            assert np.array_equal(g.numpy(), w), path
    jl = jdet.load_npz(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(np.asarray(jl["backbone"]["stem"]["w"]),
                                  rounded["backbone"]["stem"]["w"])
    # the saved detector loads into the port's Detector
    d = tdet.Detector(tdet.load_npz(str(tmp_path / "t.npz"), "cpu"), tcfg, "cpu")
    assert isinstance(d(imgs[0]), list)


# ------------------------------------------------------------------ the command lines


def test_train_orderformer_main_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "of.npz"
    res = tscript_of.main(["--samples", "16", "--heldout", "8", "--epochs", "1", "--batch", "8",
                           "--cpu", "--out", str(out)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert 0 <= res["exact_order_acc"] <= 1 and np.isfinite(res["train_loss"])
    assert tof.forward(tdet.load_npz(str(out), "cpu"), TOfCfg(),
                       torch.zeros(1, 50, 4)).shape == (1, 50, 1)
    with pytest.raises(FileNotFoundError, match="not in the repository"):
        tscript_of.main(["--samples", "4", "--cpu", "--eval-fixture"])


def test_train_detector_main_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "det.npz"
    res = tscript_det.main(["--steps", "2", "--batch", "2", "--size", "64", "--bank", "3",
                            "--max-boxes", "16", "--style", "boxes", "--device", "cpu",
                            "--out", str(out)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert len(res["per_page"]) == 8 and np.isfinite(res["final_loss"])
    assert res["style"] == "boxes" and res["checkpoint"] == str(out)
    with pytest.raises(FileNotFoundError, match="not in the repository"):
        tscript_det.main(["--steps", "1", "--device", "cpu", "--eval-fixture"])
    with pytest.raises(FileNotFoundError, match="not in the repository"):
        tdt.fixture_recall(tdet.load_npz(str(out), "cpu"), TDetCfg(img_size=64))

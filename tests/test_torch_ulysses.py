"""Ulysses sequence parallelism (parallel/ulysses.py) and the sequence-
parallel e-IT step (train/e_it.py with "seq" > 1) on the CPU.

The ranks run in one gloo world of 4 CPU ranks for the module
(tests/torch_parallel_ranks.py:ulysses_checks); the JAX side runs its
``ulysses_attention`` over the conftest's 8 virtual devices with the plain
attention (``use_flash=False``). Inputs are drawn from numpy seeds here.

Tolerances: the attention output at sp = 2 and 4 and in the inner-SP case
(2 heads over sp = 4: head_dim split) within f32 atol 1e-5 of JAX's; its
q / k / v grads within atol 1e-5 of autograd through the unsharded plain
attention; the e-IT step over data=2, seq=2 gives the unsharded step's loss
and LoRA grads within rel 1e-5 (L2 over each leaf), and the same updated
adapters within rel 1e-5.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from callireader_tpu.core import partition as jpart
from callireader_tpu.parallel import ulysses as jul
from callireader_tpu_torch.core.partition import Mesh
from callireader_tpu_torch.parallel import ulysses as tul
from callireader_tpu_torch.parallel.dryrun import run_world

HERE = os.path.dirname(os.path.abspath(__file__))
ATOL = 1e-5
REL = 1e-5
CASES = {"sp2": (2, 4, 2, 64, 16), "sp4": (4, 8, 4, 64, 16), "inner": (4, 2, 2, 32, 16)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def world():
    rng = np.random.RandomState(0)
    payload = {}
    for name, (sp, Hq, Hkv, S, D) in CASES.items():
        payload[name] = {"q": rng.randn(2, Hq, S, D).astype(np.float32),
                         "k": rng.randn(2, Hkv, S, D).astype(np.float32),
                         "v": rng.randn(2, Hkv, S, D).astype(np.float32),
                         "w": rng.randn(2, Hq, S, D).astype(np.float32)}
    B, S = 2, 64
    ids = rng.randint(10, 1000, (B, S)).astype(np.int64)
    labels = np.where(np.arange(S)[None] >= S // 2, ids, -100).astype(np.int64)
    payload["eit_batch"] = {"input_ids": ids, "labels": labels,
                            "segment_ids": np.zeros((B, S), np.int32),
                            "positions": np.tile(np.arange(S, dtype=np.int64)[None], (B, 1))}
    out = run_world(4, "torch_parallel_ranks:ulysses_checks", payload, sys_path=[HERE],
                    timeout=600)
    return payload, out


@pytest.mark.parametrize("name", list(CASES))
def test_ulysses_forward_matches_jax(world, name):
    p, out = world
    sp = CASES[name][0]
    jm = jpart.make_mesh({"data": 8 // sp, "seq": sp})
    q, k, v = (jnp.asarray(p[name][x]) for x in "qkv")
    want = jul.ulysses_attention(q, k, v, jm, causal=True)
    for r in out:
        np.testing.assert_allclose(r[name]["out"].numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_ulysses_grads_match_plain_attention(world, name):
    _, out = world
    for r in out:
        for g in ("dq", "dk", "dv"):
            np.testing.assert_allclose(r[name][g].numpy(), r[name]["ref"][g].numpy(), rtol=0,
                                       atol=ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_reduce_sequence_parallel_loss_over_ranks(world, name):
    _, out = world
    sp = CASES[name][0]
    want = sum(range(1, sp + 1)) / (2 * sp)
    assert all(r[name]["loss"] == want for r in out)


def test_inner_sp_splits_head_dim():
    sp, Hq = CASES["inner"][0], CASES["inner"][1]
    assert sp // math.gcd(Hq, sp) == 2  # the inner-SP route runs


def test_split_and_loss_reduction_local():
    mesh = Mesh.virtual({"seq": 4}, {"seq": 2})
    x = torch.arange(2 * 8).reshape(2, 8)
    assert torch.equal(tul.split_for_sequence_parallel(x, mesh), x[:, 4:6])
    with pytest.raises(ValueError):
        tul.split_for_sequence_parallel(torch.zeros(2, 6), mesh)
    assert float(tul.reduce_sequence_parallel_loss(torch.tensor(10.0), torch.tensor(5))) == 2.0


def test_sequence_parallel_eit_loss_and_lora_grads(world):
    _, out = world
    for r in out:
        loss0, g0 = r["eit"]["plain"]
        loss1, g1 = r["eit"]["sharded"]
        assert abs(loss1 - loss0) <= REL * abs(loss0)
        assert set(g0) == set(g1) and len(g0) == 14  # 7 projections x (A, B)
        for k in g0:
            assert _rel(g1[k].numpy(), g0[k].numpy()) <= REL, k


def test_sequence_parallel_eit_step_updates(world):
    _, out = world
    for r in out:
        assert _rel(r["eit"]["sharded_a"].numpy(), r["eit"]["plain_a"].numpy()) <= REL

"""The port's seed-0 draws do not depend on the device (runtime/weights.py,
``_HostInit``): every component but the LLM is drawn on the host in blocks,
each block from a CPU generator keyed by ``draw_key``. The file imports
torch and the port only, so the card runs it too:
``pytest --noconftest -m cuda tests/test_torch_seed_draws.py``."""

import dataclasses

import pytest
import torch

from callireader_tpu_torch.core.config import callireader_tiny
from callireader_tpu_torch.runtime import weights
from callireader_tpu_torch.train import callialign_train as ca


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


ROWS = (5 * weights.BLOCK // 2) // 64  # a (ROWS, 64) leaf spans 2.5 blocks


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix: tree}


def test_host_draw_blocks_follow_draw_key():
    """Block j of the table (leaf 1 of ``align``) is what a CPU generator
    seeded with ``draw_key(seed, "align", 1, j)`` draws alone, bit for bit,
    and the table is the same with one thread as with many."""
    table = weights.draw_align_table(ROWS, 64, 5, dtype=torch.float32, device="cpu")
    flat = table.view(-1)
    for j in range(3):
        blk = flat[j * weights.BLOCK:(j + 1) * weights.BLOCK]
        gen = torch.Generator().manual_seed(weights.draw_key(5, "align", 1, j))
        assert torch.equal(blk, torch.empty(blk.numel()).normal_(generator=gen)), j
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        one = weights.draw_align_table(ROWS, 64, 5, dtype=torch.float32, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(one, table)


def test_seed0_leaves_are_the_same_alone_and_in_any_dtype():
    """The bf16 table is the float32 one cast, and a component's leaves are
    the same drawn alone or inside ``init_params``."""
    f32 = weights.draw_align_table(ROWS, 64, 0, dtype=torch.float32, device="cpu")
    bf16 = weights.draw_align_table(ROWS, 64, 0, dtype=torch.bfloat16, device="cpu")
    assert torch.equal(f32.to(torch.bfloat16), bf16)
    cfg = callireader_tiny()
    full = weights.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    alone = weights.draw_vision(cfg.vision, 0, dtype=torch.float32, device="cpu")
    for k, v in _flat(alone).items():
        assert torch.equal(_flat(full["vision"])[k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_seed0_draws_equal_the_host_draws(cuda, dtype):
    """Every component but the LLM is drawn on the card as on the CPU, bit
    for bit: the table of 2.5 blocks, the trainer's seed-0 helpers and the
    whole tiny tree."""
    want = weights.draw_align_table(ROWS, 64, 0, dtype=dtype, device="cpu")
    assert torch.equal(weights.draw_align_table(ROWS, 64, 0, dtype=dtype, device=cuda).cpu(),
                       want)
    cfg = callireader_tiny()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_hidden_layers=1))
    got = weights.init_params(cfg, 0, dtype=dtype, device=cuda)
    host = weights.init_params(cfg, 0, dtype=dtype, device="cpu")
    for name in host:
        if name == "llm":  # drawn on the device: CUDA's Philox stream
            continue
        g, h = _flat(got[name]), _flat(host[name])
        assert sorted(g) == sorted(h), name
        for k in h:
            assert g[k].device.type == "cuda" and torch.equal(g[k].cpu(), h[k]), (name, k)
    for k, v in _flat(ca.base_resampler_params(cfg.resampler, dtype, cuda)).items():
        assert torch.equal(v.cpu(), _flat(host["resampler"])[k]), k
    for k, v in _flat(ca.base_vision_params(cfg, dtype, cuda)).items():
        assert torch.equal(v.cpu(), _flat(host["vision"])[k]), k

"""Mixtral-style sparse-MoE decoder (PyTorch port of
callireader_tpu/models/moe.py).

Parity target: the reference's vendored MoE training modules
(train/xtuner/model/modeling_mixtral.py, modeling_deepseek.py): top-k softmax
routing over SwiGLU experts with the load-balancing aux loss. The expert
weights are stacked ``(L, X, ...)`` leaves, the JAX tree's layout, so
``runtime.weights.from_jax_params`` carries a tree across unchanged. Routing
is dense, as in the JAX module: every expert runs on every token, scaled by
its (mostly zero) routing weight; those einsums are plain ``torch``
products, as JAX leaves them to XLA.

The attention stack is internlm2.py's: GQA, RoPE, RMSNorm (kernels/rmsnorm.py
on the card). ``forward`` launches kernels/attention.flash_attention (causal,
segment ids), which the card runs for (D, Hq // Hkv) in
kernels.attention.SUPPORTED_SHAPES: the default ``MoEConfig`` (D=128, G=4);
``moe_tiny`` (D=16, G=2) runs there only through ``use_flash=False``, the
JAX API's explicit plain route.

Expert parallelism (``mesh=`` with an "expert" axis; the mesh holds "data"
and "expert" only): each rank holds X/expert experts of every layer
(``spmd.shard_tree`` by ``logical_axes``), runs every token of its rows
through them and the outputs are added over "expert"; the tokens and the
routing weights enter that block through ``spmd.copy_to``, so that every
rank of the expert group ends with the same grads for the whole leaves. The
load-balancing statistics are added over "data": the aux loss is that of
the whole batch. ``make_train_step`` is the expert-parallel step (rows over
"data", grads added over it, Adam on each rank's blocks).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from callireader_tpu_torch.core.config import LLMConfig
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy, require_device
from callireader_tpu_torch.kernels.attention import attention_reference, flash_attention
from callireader_tpu_torch.models import internlm2

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    llm: LLMConfig = dataclasses.field(default_factory=LLMConfig)
    num_experts: int = 8
    num_experts_per_tok: int = 2
    router_aux_loss_coef: float = 0.02


def moe_tiny() -> MoEConfig:
    return MoEConfig(
        llm=LLMConfig(
            vocab_size=512, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        ),
        num_experts=4,
        num_experts_per_tok=2,
    )


def init_params(cfg: MoEConfig, generator: torch.Generator, dtype=torch.bfloat16,
                device="cuda") -> Params:
    """The JAX tree: N(0, 0.02) kernels drawn in fp32, unit norms."""
    llm = cfg.llm
    L, E, M, X = llm.num_hidden_layers, llm.hidden_size, llm.intermediate_size, cfg.num_experts
    Hq, Hkv, D, V = llm.num_attention_heads, llm.num_key_value_heads, llm.head_dim, llm.vocab_size
    dev = require_device(device)

    def w(*shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
                * 0.02).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    return {
        "tok_embeddings": w(V, E),
        "layers": {
            "attn_norm": ones(L, E),
            "ffn_norm": ones(L, E),
            "wq": w(L, E, Hq * D),
            "wk": w(L, E, Hkv * D),
            "wv": w(L, E, Hkv * D),
            "wo": w(L, Hq * D, E),
            "router": w(L, E, X),
            "w1": w(L, X, E, M),  # gate, per expert
            "w3": w(L, X, E, M),  # up
            "w2": w(L, X, M, E),  # down
        },
        "norm": ones(E),
        "output": w(V, E),
    }


def logical_axes(cfg: MoEConfig) -> Params:
    """Logical sharding annotations: the experts over "expert"."""
    del cfg
    return {
        "tok_embeddings": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("stack", "norm"),
            "ffn_norm": ("stack", "norm"),
            "wq": ("stack", "embed", "qkv"),
            "wk": ("stack", "embed", "qkv"),
            "wv": ("stack", "embed", "qkv"),
            "wo": ("stack", "qkv", "embed"),
            "router": ("stack", "embed", None),
            "w1": ("stack", "expert", "embed", "mlp"),
            "w3": ("stack", "expert", "embed", "mlp"),
            "w2": ("stack", "expert", "mlp", "embed"),
        },
        "norm": ("norm",),
        "output": ("vocab", "embed"),
    }


def _moe_mlp(p, x: torch.Tensor, cfg: MoEConfig, policy: DTypePolicy, mesh=None):
    """Routed SwiGLU experts, dense: softmax over the router logits in fp32,
    the top k renormalised (mixtral) and scattered into a (T, X) weight that
    is zero elsewhere. Returns (x + out, router_probs (T, X)). Under a mesh
    the layer's expert leaves are the rank's X/expert experts."""
    K = cfg.num_experts_per_tok
    B, S, E = x.shape
    h = internlm2.rms_norm(x, p["ffn_norm"], cfg.llm.rms_norm_eps, policy)
    flat = h.reshape(B * S, E)

    logits = (flat @ p["router"].to(flat.dtype)).float()  # (T, X)
    probs = torch.softmax(logits, dim=-1)
    topk_vals, topk_idx = torch.topk(probs, K, dim=-1)
    topk_vals = topk_vals / topk_vals.sum(dim=-1, keepdim=True)
    weight = torch.zeros_like(probs).scatter(-1, topk_idx, topk_vals)
    if mesh is not None:
        from callireader_tpu_torch.parallel import spmd

        n = p["w1"].shape[0]
        lo = mesh.rank("expert") * n
        flat = spmd.copy_to(flat, mesh, "expert")
        weight = spmd.copy_to(weight, mesh, "expert")[:, lo:lo + n]

    gate = F.silu(torch.einsum("te,xem->txm", flat, p["w1"].to(flat.dtype)))
    up = torch.einsum("te,xem->txm", flat, p["w3"].to(flat.dtype))
    expert_out = torch.einsum("txm,xme->txe", gate * up, p["w2"].to(flat.dtype))
    out = torch.einsum("txe,tx->te", expert_out, weight.to(flat.dtype))
    if mesh is not None:
        out = spmd.all_reduce(out, mesh, "expert")
    return x + out.reshape(B, S, E), probs


def load_balancing_loss(all_probs: torch.Tensor, cfg: MoEConfig, mesh=None) -> torch.Tensor:
    """Switch-style aux loss: X * sum(mean_prob * mean_top1_assignment);
    under a mesh the means are over the tokens of every data rank."""
    X = cfg.num_experts
    if mesh is None:
        mean_prob = all_probs.mean(dim=0)  # (X,)
        assign = F.one_hot(all_probs.argmax(dim=-1), X).to(all_probs.dtype).mean(dim=0)
        return X * (mean_prob * assign).sum()
    import torch.distributed as dist

    from callireader_tpu_torch.parallel import spmd

    n = torch.tensor([float(all_probs.shape[0])], device=all_probs.device)
    assign = F.one_hot(all_probs.argmax(dim=-1), X).to(all_probs.dtype).sum(dim=0)
    for t in (n, assign):
        dist.all_reduce(t, group=mesh.group("data"))
    mean_prob = spmd.all_reduce(all_probs.sum(dim=0), mesh, "data") / n
    return X * (mean_prob * (assign / n)).sum()


def _rope(llm: LLMConfig, positions: torch.Tensor, S: int):
    """The JAX module's tables: the dynamic-NTK base set by the static S."""
    base = llm.rope_theta
    if llm.rope_scaling_type == "dynamic" and S > llm.max_position_embeddings:
        f = llm.rope_scaling_factor
        base = base * ((f * S / llm.max_position_embeddings) - (f - 1)) ** (
            llm.head_dim / (llm.head_dim - 2))
    inv = internlm2._inv_freq(llm, base, positions.device)
    freqs = positions.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def forward(
    params: Params,
    cfg: MoEConfig,
    *,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    policy: DTypePolicy = DEFAULT_POLICY,
    use_flash: Optional[bool] = None,
    return_aux_loss: bool = False,
    mesh=None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """-> logits (B, S, V) in the policy's logits dtype, and with
    ``return_aux_loss`` the weighted load-balancing loss. Causal attention
    within equal segment ids: kernels/attention.flash_attention (its plain
    version on CPU tensors), or ``attention_reference`` where
    ``use_flash=False``. ``mesh``: expert parallel (the module docstring),
    the rows this data rank's."""
    if mesh is not None and any(mesh.axis_size(a) > 1 for a in mesh.axis_names
                                if a not in ("data", "expert")):
        raise ValueError(f"the MoE shards over data and expert only, not {mesh.shape}")
    llm = cfg.llm
    if inputs_embeds is None:
        inputs_embeds = params["tok_embeddings"][input_ids.long()]
    x = inputs_embeds.to(policy.compute_dtype)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    cos, sin = _rope(llm, positions, S)
    attend = flash_attention if use_flash is None or use_flash else attention_reference

    all_probs = []
    for i in range(llm.num_hidden_layers):
        p = internlm2._layer(params, i)
        h = internlm2.rms_norm(x, p["attn_norm"], llm.rms_norm_eps, policy)
        q, k, v = internlm2._qkv(p, h, llm)
        q = internlm2.apply_rope(q, cos, sin).contiguous()
        k = internlm2.apply_rope(k, cos, sin).contiguous()
        ctx = attend(q, k, v.contiguous(), causal=True, q_segment_ids=segment_ids,
                     kv_segment_ids=segment_ids)
        x = x + ctx.transpose(1, 2).reshape(B, S, -1) @ p["wo"].to(ctx.dtype)
        x, probs = _moe_mlp(p, x, cfg, policy, mesh)
        all_probs.append(probs)
    x = internlm2.rms_norm(x, params["norm"], llm.rms_norm_eps, policy)
    logits = (x @ params["output"].to(x.dtype).T).to(policy.logits_dtype)
    if return_aux_loss:
        aux = load_balancing_loss(torch.cat(all_probs), cfg, mesh)
        return logits, cfg.router_aux_loss_coef * aux
    return logits


def loss_and_grads(params: Params, cfg: MoEConfig, input_ids: torch.Tensor, *,
                   policy: DTypePolicy = DEFAULT_POLICY, use_flash: Optional[bool] = False,
                   mesh=None):
    """Next-token NLL of the whole batch plus the aux loss -> (loss, {path:
    grad}) over every leaf (the rank's blocks under a mesh). ``input_ids``
    is the whole batch; under a mesh each data rank runs its rows, and the
    grads are added over "data"."""
    from callireader_tpu_torch.train import e_it

    flat = e_it.flatten(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    ids = input_ids
    if mesh is not None:
        from callireader_tpu_torch.core.partition import local_shard

        ids = local_shard(input_ids, ("data",), mesh)
    logits, aux = forward(e_it.replace_leaves(params, leaves), cfg, input_ids=ids, policy=policy,
                          use_flash=use_flash, return_aux_loss=True, mesh=mesh)
    lab = ids[:, 1:].long()
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll_sum = -torch.gather(lp, -1, lab[..., None]).sum()
    n_all = input_ids.shape[0] * (input_ids.shape[1] - 1)
    loss = nll_sum / n_all + aux
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    if mesh is not None:
        import torch.distributed as dist

        from callireader_tpu_torch.parallel import spmd

        spmd.reduce_grads(grads, mesh, ("data",))
        total = nll_sum.detach().clone()
        dist.all_reduce(total, group=mesh.group("data"))
        loss = total / n_all + aux.detach()
    return loss.detach(), grads


def make_train_step(cfg: MoEConfig, learning_rate: float = 1e-3, *,
                    policy: DTypePolicy = DEFAULT_POLICY, use_flash: Optional[bool] = False,
                    mesh=None):
    """Adam (optax.adam: b 0.9 / 0.999, eps 1e-8, no decay) over every leaf
    -> (init(params) -> opt_state, step(params, opt_state, input_ids) ->
    loss); the step writes the params and moments in place. Under a mesh
    the params are the rank's blocks and ``input_ids`` the whole batch."""
    from callireader_tpu_torch.train import e_it

    tx = e_it.Optimizer(lambda count: learning_rate)

    def init(params):
        return tx.init(e_it.flatten(params))

    def step(params, opt_state, input_ids):
        loss, grads = loss_and_grads(params, cfg, input_ids, policy=policy, use_flash=use_flash,
                                     mesh=mesh)
        tx.update(grads, opt_state, e_it.flatten(params))
        return loss

    return init, step

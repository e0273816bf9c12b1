"""The control and the faults of the MLA-MoE cell (``interpret.moonlight_a3b``),
planted in the served program before it serves: each has to read above the
cell's limits (``limits/interpret.moonlight_a3b.json``), judged by the float32
reference as a run's sample is. ``plant(engine, name)``:

- ``fp8`` / ``int4``: the control, the routed experts' weights (the served
  ``w13`` and ``w2``) rounded a output channel to fp8 e4m3 at absmax / 448,
  or to int4 at absmax / 7;
- ``no_shared``: the shared experts left out (their down projection zeroed);
- ``no_scale``: ``routed_scaling_factor`` left out (1 in its place);
- ``no_bias``: the correction bias left out of the selection (zeroed).
"""

import dataclasses

import torch

VARIANTS = ("fp8", "int4", "no_shared", "no_scale", "no_bias")


def plant(engine, name: str) -> None:
    moe = engine.params["llm"]["moe"]
    if name == "no_shared":
        moe["shared_w2"].zero_()
    elif name == "no_bias":
        moe["gate_bias"].zero_()
    elif name == "no_scale":
        engine.cfg = dataclasses.replace(engine.cfg, llm=dataclasses.replace(engine.cfg.llm,
                                                                             routed_scaling_factor=1.0))
    elif name in ("fp8", "int4"):
        top = 448.0 if name == "fp8" else 7.0
        for leaf in ("w13", "w2"):
            for i in range(moe[leaf].shape[0]):
                w = moe[leaf][i].float()  # (experts, in, out): a scale an output channel
                s = w.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / top
                q = ((w / s).to(torch.float8_e4m3fn).float() if name == "fp8"
                     else torch.clamp(torch.round(w / s), -7, 7))
                moe[leaf][i].copy_((q * s).to(moe[leaf].dtype))
    else:
        raise ValueError(f"no variant {name!r}; have {VARIANTS}")

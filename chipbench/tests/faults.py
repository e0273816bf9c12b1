"""Faults planted under the timed path for the benchmark's tests, each
installed with pytest's ``monkeypatch``: a run that carries one has to come
out not correct."""


def altered_tokens(monkeypatch):
    """Every sampled token moved to its neighbour where it is produced."""
    from callireader_tpu_torch.runtime import generate

    real = generate._sample
    monkeypatch.setattr(generate, "_sample", lambda lg, g, gen: (real(lg, g, gen) + 1) % 92553)


def swapped_order(monkeypatch):
    """The box stage's first two boxes of each page in the wrong order."""
    from callireader_tpu_torch.runtime.engine import CalliReaderEngine

    real = CalliReaderEngine.order_fetch

    def swapped(self, st, thres=0.8):
        out = real(self, st, thres)
        return [([o[1], o[0]] + list(o[2:])) if o is not None and len(o) > 1 else o for o in out]

    monkeypatch.setattr(CalliReaderEngine, "order_fetch", swapped)


def half_batch(monkeypatch):
    """Half of each micro-batch left out (its rows, and the tiles and pseudo
    rows they splice): the loss becomes the mean over the rest."""
    from chipbench.drivers import eit

    real = eit.feed

    def half(mb, cfg):
        b = real(mb, cfg)
        n = b["input_ids"].shape[0] // 2
        out = {k: b[k][:n] for k in ("input_ids", "labels", "segment_ids", "positions")}
        ids = b["input_ids"][:n]
        out["pixel_values"] = b["pixel_values"][:int((ids == cfg["img_context_token_id"]).sum())
                                                // cfg["num_image_token"]]
        out["pseudo_embeds"] = b["pseudo_embeds"][:int((ids == cfg["aligned_token_id"]).sum())]
        return out

    monkeypatch.setattr(eit, "feed", half)


def unchanged_state(monkeypatch):
    """The optimizer's update skipped: a step returns its state unchanged."""
    from callireader_tpu_torch.train import e_it

    monkeypatch.setattr(e_it.Optimizer, "_apply", lambda self, grads, state, params, norm_fn=None:
                        state.update(count=state["count"] + 1))

"""Interactive chat CLI with token streaming (PyTorch port of
callireader_tpu/cli/chat.py).

  python -m callireader_tpu_torch.cli.chat --image page.npy --preset callireader-8b \
      --random-init --quant int8

``stream_generate`` prefills the prompt, then decodes step by step through
``internlm2.decode_step``, printing the text as it grows and stopping at the
template's separator, the tokenizer's eos, or a stop word. The REPL keeps
the history; ``RESET`` clears it, ``EXIT`` quits. ``--quant int8-all`` adds
the W8A8 tile tower to the int8 LLM. ``--agent`` routes each line through
the ReAct agent (runtime/agent.py: calculate / solve / search tools), whose
turns are ``stream_generate`` calls that stop at "Response:". Runs on the
GPU unless ``--device cpu`` is given. Not offered: what cli/common.py
refuses.
"""

from __future__ import annotations

import argparse
import os
import sys


def stream_generate(engine, question, history, *, image=None, max_new_tokens=512,
                    repetition_penalty=1.0, stop_words=(), out=None):
    """One turn: prompt (with the page's tiles when ``image`` is given) ->
    (response, history), the text written to ``out`` (stdout) as it grows."""
    import numpy as np
    import torch

    from callireader_tpu_torch.models import internlm2
    from callireader_tpu_torch.runtime import generate as gen
    from callireader_tpu_torch.runtime.conversation import build_chat_prompt
    from callireader_tpu_torch.vision import preprocess

    out = sys.stdout if out is None else out
    cfg = engine.cfg
    img_embeds = None
    num_patches_list = []
    if image is not None:
        pixel_values = preprocess.load_image(preprocess.open_image(image), cfg.force_image_size,
                                             cfg.max_dynamic_patch, cfg.use_thumbnail)
        num_patches_list = [pixel_values.shape[0]]
        img_embeds = engine.encode_image_tiles(engine._to_dev(pixel_values))
        if "<image>" not in question and history is None:
            question = "<image>\n" + question

    conv = build_chat_prompt(question, history)
    query = engine._expand_image_tokens(conv.get_prompt(), num_patches_list)
    ids = np.asarray(engine.tok.encode(query), np.int32)
    bucket = gen.bucket_length(len(ids))
    embeds, mask = engine._build_row_embeds(ids, img_embeds, None, bucket)
    max_cache = bucket + max_new_tokens
    llm = engine.params["llm"]
    eos = engine.tok.convert_tokens_to_ids(conv.sep)
    pieces, printed = [], ""
    with torch.inference_mode():
        logits, cache = internlm2.prefill(llm, cfg.llm, inputs_embeds=embeds,
                                          attention_mask=engine._to_dev(mask), max_len=max_cache,
                                          policy=engine.policy)
        kv_valid = torch.zeros((1, max_cache), dtype=torch.int32, device=engine.device)
        kv_valid[0, :bucket] = engine._to_dev(mask[0])
        seen = torch.zeros((logits.shape[-1],), dtype=torch.bool, device=engine.device)
        for _ in range(max_new_tokens):
            lg = logits[0]
            if repetition_penalty != 1.0:
                pen = torch.where(lg < 0, lg * repetition_penalty, lg / repetition_penalty)
                lg = torch.where(seen, pen, lg)
            tok_id = int(lg.argmax())
            if tok_id in (eos, engine.tok.eos_token_id):
                break
            seen[tok_id] = True
            pieces.append(tok_id)
            text = engine.tok.decode(pieces, skip_special_tokens=True)
            stop = next((w for w in stop_words if text.endswith(w)), None)
            if stop is not None:
                text = text[:-len(stop)]
                out.write(text[len(printed):])
                printed = text
                break
            out.write(text[len(printed):])
            out.flush()
            printed = text
            kv_valid[0, cache.length] = 1
            logits, cache = internlm2.decode_step(
                llm, cfg.llm, input_ids=torch.full((1, 1), tok_id, dtype=torch.int32,
                                                   device=engine.device),
                cache=cache, kv_valid_mask=kv_valid, policy=engine.policy)
    out.write("\n")
    response = engine.tok.decode(pieces, skip_special_tokens=True).strip()
    history = list(history or [])
    history.append((question, response))
    return response, history


def main(argv=None):
    parser = argparse.ArgumentParser(description="interactive chat")
    parser.add_argument("--image", type=str, default=None)
    parser.add_argument("--preset", type=str, default="callireader-8b")
    parser.add_argument("--checkpoint", type=str, default=os.environ.get("CALLIREADER_CKPT"),
                        help="InternVL checkpoint directory (reference layout)")
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--quant", type=str, default=None, choices=[None, "int8", "int8-all"])
    parser.add_argument("--adapter", type=str, default=None,
                        help="e-IT checkpoint dir of cli.train (LoRA + projector) to merge")
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--repetition-penalty", type=float, default=1.0)
    parser.add_argument("--system", type=str, default=None)
    parser.add_argument("--stop-words", type=str, nargs="*", default=[])
    parser.add_argument("--agent", action="store_true",
                        help="ReAct agent mode with calculate/solve/search tools (the reference "
                        "chat tool's --lagent mode, tools/chat.py:172-213)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from callireader_tpu_torch.cli import common

    try:
        engine = common.build_engine(preset=args.preset, checkpoint_dir=args.checkpoint,
                                     random_init_ok=args.random_init, quant=args.quant,
                                     adapter_path=args.adapter, device=args.device)
    except (NotImplementedError, FileNotFoundError, ValueError) as e:
        parser.error(str(e))
    history = None
    agent = None
    if args.agent:
        from callireader_tpu_torch.runtime.agent import ReActAgent

        def _chat_fn(question, hist):
            return stream_generate(engine, question, hist, max_new_tokens=args.max_new_tokens,
                                   repetition_penalty=args.repetition_penalty,
                                   stop_words=("Response:",))

        agent = ReActAgent(_chat_fn)
    print("double enter to end input; 'RESET' clears history, 'EXIT' quits", file=sys.stderr)
    while True:
        try:
            text = input("\nuser> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not text:
            continue
        if text == "EXIT":
            break
        if text == "RESET":
            history = None
            if agent is not None:
                agent.reset()
            print("history cleared", file=sys.stderr)
            continue
        print("assistant> ", end="", flush=True)
        if agent is not None:
            print(agent.chat(text))
            continue
        _, history = stream_generate(
            engine, text, history, image=args.image if history is None else None,
            max_new_tokens=args.max_new_tokens, repetition_penalty=args.repetition_penalty,
            stop_words=tuple(args.stop_words),
        )


if __name__ == "__main__":
    main()

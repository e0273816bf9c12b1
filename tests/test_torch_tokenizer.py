"""The port's pure-Python tokenizer against the JAX package's HF-tokenizers
build: identical ids on encode, identical text on decode (exact match)."""

import numpy as np
import pytest

from callireader_tpu.runtime.conversation import build_chat_prompt
from callireader_tpu.runtime.tokenizer import InternLM2Tokenizer as JTok
from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer as TTok


@pytest.fixture(scope="module")
def toks():
    return JTok("callireader_tpu/assets/tokenizer.model"), TTok()


def _ocr_prompt():
    q = "<img>" + "<IMG_CONTEXT>" * 256 * 3 + "</img>\n读出图中所有文字。" + "[UNUSED_TOKEN_140]" * 12
    return build_chat_prompt(q).get_prompt()


STRINGS = [
    _ocr_prompt(),
    "读出图中所有文字。",
    "这幅书法作品内容是什么？",
    "床前明月光，疑是地上霜。举头望明月，低头思故乡。",
    "Hello, world!",
    "mixed 中文 and ASCII 123 — dash",
    "two  spaces   three    four",
    " leading and trailing ",
    "tabs\tnewlines\nand\r\ncarriage returns",
    "emoji 😀🎉 and rare 𠀀𪚥 glyphs",
    "控制字符\x00\x07 bytes",
    "ünïcödé café naïve",
    "<|im_start|>user\n你好<|im_end|><|im_start|>assistant\n",
    "<ref>box</ref><box>[[1, 2, 3, 4]]</box><quad>",
    "[UNUSED_TOKEN_140][UNUSED_TOKEN_140]text[UNUSED_TOKEN_141]",
    "aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa",
    "http://example.com/path?x=1&y=2#frag",
    "龘靐齉爩 籲",
    "",
    "   ",
    "1234567890 3.14159 -42",
]


@pytest.mark.parametrize("i", range(len(STRINGS)))
def test_encode_ids_match(toks, i):
    jt, tt = toks
    assert tt.encode(STRINGS[i]) == jt.encode(STRINGS[i])
    assert tt.encode(STRINGS[i], add_bos=False) == jt.encode(STRINGS[i], add_bos=False)


@pytest.mark.parametrize("skip", [True, False])
def test_decode_matches(toks, skip):
    jt, tt = toks
    rng = np.random.default_rng(int(skip))
    for _ in range(100):
        ids = rng.integers(0, 92554, size=int(rng.integers(1, 40))).tolist()
        ids += rng.integers(3, 259, size=int(rng.integers(0, 6))).tolist()  # byte pieces
        ids += [92542, 92546, 92537, 2][: int(rng.integers(0, 5))]
        assert tt.decode(ids, skip_special_tokens=skip) == jt.decode(ids, skip_special_tokens=skip)
    for s in STRINGS:
        ids = jt.encode(s)
        assert tt.decode(ids, skip_special_tokens=skip) == jt.decode(ids, skip_special_tokens=skip)


def test_special_token_ids_match(toks):
    jt, tt = toks
    for tok in ("<|im_end|>", "<|im_start|>", "<IMG_CONTEXT>", "[UNUSED_TOKEN_140]", "<img>",
                "</img>", "<ALIGNED_TOKEN>", "<s>", "</s>"):
        assert tt.convert_tokens_to_ids(tok) == jt.convert_tokens_to_ids(tok)
    assert tt.vocab_size == jt.vocab_size

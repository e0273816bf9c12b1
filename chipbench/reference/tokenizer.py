"""InternLM2 tokenizer in pure Python, a frozen copy of the port's runtime/tokenizer.py
(no sentencepiece, tokenizers, transformers or protobuf package).

Reads the SentencePiece ``tokenizer.model`` with a hand-written protobuf
wire-format reader and reproduces what callireader_tpu/runtime/tokenizer.py
builds with HuggingFace ``tokenizers``:

- added tokens (the specials, the tokenizer_config renames of ids
  92538-92543, the appended <img> ... <ALIGNED_TOKEN> at 92544+, and the
  model's USER_DEFINED pieces) are split out of the raw text first, by
  leftmost-longest literal match;
- each remaining span maps " " to "▁" (identity normaliser, no dummy prefix,
  no pre-tokenizer) and goes through BPE as one word: characters missing from
  the vocab fall back to their UTF-8 bytes <0xXX>, unknowns fuse, and merges
  apply lowest rank first, leftmost on ties (HF's merge queue); the merges
  are recovered from piece ids as ``_extract_merges`` does;
- decode maps "▁" back to " ", turns runs of byte pieces into UTF-8 (each
  byte of an invalid run becomes U+FFFD) and, with ``skip_special_tokens``,
  drops the special added tokens (USER_DEFINED pieces are not special).
"""

from __future__ import annotations

import heapq
import struct
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

RENAMES = {
    92538: "<|plugin|>",
    92539: "<|interpreter|>",
    92540: "<|action_end|>",
    92541: "<|action_start|>",
    92542: "<|im_end|>",
    92543: "<|im_start|>",
}
APPENDED = [
    "<img>", "</img>", "<IMG_CONTEXT>", "<quad>", "</quad>",
    "<ref>", "</ref>", "<box>", "</box>", "<ALIGNED_TOKEN>",
]
UNK_ID, BOS_ID, EOS_ID, PAD_ID = 0, 1, 2, 2
_PIECE_NORMAL, _PIECE_USER = 1, 4

DEFAULT_MODEL = str(
    Path(__file__).resolve().parents[2] / "callireader_tpu" / "assets" / "tokenizer.model"
)


# ----------------------------------------------------------- protobuf reader


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field number, wire type, value) of one message; value is an int
    for varint/fixed fields and a bytes slice for length-delimited ones."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 2:
            ln, i = _varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def read_pieces(model_path: str) -> List[Tuple[str, float, int]]:
    """ModelProto.pieces (field 1) -> [(piece, score, type)]; type defaults
    to NORMAL (1) when absent."""
    data = Path(model_path).read_bytes()
    pieces = []
    for field, wire, val in _fields(data):
        if field != 1 or wire != 2:
            continue
        piece, score, ptype = "", 0.0, _PIECE_NORMAL
        for f, w, v in _fields(val):
            if f == 1 and w == 2:
                piece = v.decode("utf-8")
            elif f == 2 and w == 5:
                score = struct.unpack("<f", v)[0]
            elif f == 3 and w == 0:
                ptype = v
        pieces.append((piece, score, ptype))
    return pieces


# ---------------------------------------------------------------------- BPE


def _extract_merges(vocab: Dict[str, int], normal_pieces: Sequence[str]) -> List[Tuple[str, str]]:
    """Every split of a vocab piece whose halves are both in the vocab is a
    merge; ordered by merged-piece id, then by (left id, right id)."""
    merges = []
    for piece in normal_pieces:
        if len(piece) < 2:
            continue
        pid = vocab[piece]
        local = []
        for i in range(1, len(piece)):
            left, right = piece[:i], piece[i:]
            if left in vocab and right in vocab:
                local.append((vocab[left], vocab[right], left, right))
        local.sort(key=lambda x: (x[0], x[1]))
        merges.extend((pid, left, right) for _, _, left, right in local)
    merges.sort(key=lambda x: x[0])
    return [(left, right) for _, left, right in merges]


class InternLM2Tokenizer:
    """encode / decode / convert_tokens_to_ids, id-for-id with the JAX
    package's tokenizer."""

    def __init__(self, model_path: str = DEFAULT_MODEL):
        pieces = read_pieces(model_path)
        vocab: Dict[str, int] = {}
        user_defined: List[str] = []
        normal: List[str] = []
        for i, (p, _score, ptype) in enumerate(pieces):
            piece = RENAMES.get(i, p)
            vocab[piece] = i
            if ptype == _PIECE_USER and i not in RENAMES:
                user_defined.append(piece)
            elif ptype == _PIECE_NORMAL:
                normal.append(p)
        self._vocab = vocab
        self._merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, (left, right) in enumerate(_extract_merges(vocab, normal)):
            self._merges[(vocab[left], vocab[right])] = (rank, vocab[left + right])

        specials = ["<unk>", "<s>", "</s>"] + list(RENAMES.values()) + APPENDED
        self._added: Dict[str, int] = {}
        next_id = len(pieces)
        for tok in specials + user_defined:
            if tok in self._added:
                continue
            if tok in vocab:
                self._added[tok] = vocab[tok]
            else:
                self._added[tok] = next_id
                next_id += 1
        self._special = set(specials)
        self._id_to_token = {i: p for p, i in vocab.items()}
        self._id_to_token.update({i: t for t, i in self._added.items()})
        self._by_first: Dict[str, List[str]] = {}
        for tok in self._added:
            self._by_first.setdefault(tok[0], []).append(tok)
        for lst in self._by_first.values():
            lst.sort(key=len, reverse=True)
        self._byte_ids = [vocab.get(f"<0x{b:02X}>") for b in range(256)]
        self.bos_token_id = BOS_ID
        self.eos_token_id = EOS_ID
        self.pad_token_id = PAD_ID
        self.unk_token_id = UNK_ID

    @property
    def vocab_size(self) -> int:
        return len(self._id_to_token)

    # -- encode -------------------------------------------------------------

    def _split_added(self, text: str) -> List[Tuple[bool, str]]:
        out: List[Tuple[bool, str]] = []
        i, start, n = 0, 0, len(text)
        while i < n:
            match = None
            for tok in self._by_first.get(text[i], ()):
                if text.startswith(tok, i):
                    match = tok
                    break
            if match is None:
                i += 1
                continue
            if start < i:
                out.append((False, text[start:i]))
            out.append((True, match))
            i += len(match)
            start = i
        if start < n:
            out.append((False, text[start:]))
        return out

    def _bpe(self, word: str) -> List[int]:
        syms: List[int] = []
        unk = False
        for ch in word:
            tid = self._vocab.get(ch)
            if tid is not None:
                if unk:
                    syms.append(UNK_ID)
                    unk = False
                syms.append(tid)
                continue
            byte_ids = [self._byte_ids[b] for b in ch.encode("utf-8")]
            if all(b is not None for b in byte_ids):
                syms.extend(byte_ids)
                continue
            unk = True  # fuse_unk: consecutive unknowns become one <unk>
        if unk:
            syms.append(UNK_ID)
        n = len(syms)
        if n == 0:
            return syms
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        alive = [True] * n
        merges = self._merges
        heap = []
        for i in range(n - 1):
            m = merges.get((syms[i], syms[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = merges.get((syms[pos], syms[right]))
            if m is None or m[1] != new_id:
                continue  # stale queue entry
            syms[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] != -1:
                prev[nxt[pos]] = pos
            if prev[pos] >= 0:
                m = merges.get((syms[prev[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] != -1:
                m = merges.get((new_id, syms[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, a in zip(syms, alive) if a]

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids: List[int] = [BOS_ID] if add_bos else []
        for is_added, part in self._split_added(text):
            if is_added:
                ids.append(self._added[part])
            else:
                ids.extend(self._bpe(part.replace(" ", "▁")))
        return ids

    # -- decode -------------------------------------------------------------

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out: List[str] = []
        pending = bytearray()

        def flush():
            if pending:
                try:
                    out.append(pending.decode("utf-8"))
                except UnicodeDecodeError:
                    out.append("�" * len(pending))
                pending.clear()

        for tid in ids:
            tok = self._id_to_token.get(int(tid))
            if tok is None or (skip_special_tokens and tok in self._special):
                continue
            tok = tok.replace("▁", " ")
            if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
                try:
                    pending.append(int(tok[3:5], 16))
                    continue
                except ValueError:
                    pass
            flush()
            out.append(tok)
        flush()
        return "".join(out)

    def convert_tokens_to_ids(self, token: str) -> int:
        tid = self._added.get(token, self._vocab.get(token))
        if tid is None:
            raise KeyError(token)
        return tid

    def convert_ids_to_tokens(self, tid: int) -> Optional[str]:
        return self._id_to_token.get(int(tid))


_DEFAULT = None


def default_tokenizer(model_path: str = DEFAULT_MODEL) -> InternLM2Tokenizer:
    """The tokenizer of ``model_path``, built once per process: later calls
    return the first one whatever path they name, as the JAX function does."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = InternLM2Tokenizer(model_path)
    return _DEFAULT

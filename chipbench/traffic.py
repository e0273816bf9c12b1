"""The one generator of the cells' inputs. A traffic mix is a data file
(``traffic/<name>.json``) of parameters; everything drawn comes from
``--seed``, and every seed gets the same set of sizes in another order, so
that two seeds do the same work.

Pages (``"kind": "pages"``): synthetic calligraphy pages, the structure of
the repository's bench page (``make_page``): columns of glyphs read right to
left, each glyph a few dark strokes on a light box, on a noisy ground. A
batch holds one page of each layout on the even grid from the fewest to
the most columns and characters a column; the seed orders the pages of a
batch and draws their pixels. The pool holds ``pool_batches`` such batches,
and a closed loop cycles through it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, *stream])


def layouts(spec: Dict) -> List[Tuple[int, int]]:
    """The (columns, chars a column) of the pages of one batch, on an even
    grid over the traffic's ranges."""
    B = spec["batch"]
    cols = np.rint(np.linspace(*spec["columns"], B)).astype(int)
    chars = np.rint(np.linspace(*spec["chars_per_column"], B)).astype(int)
    return [(int(c), int(n)) for c, n in zip(cols, chars)]


def make_page(g: np.random.Generator, n_cols: int, chars_per_col: int, spec: Dict):
    """-> (page uint8 (H, W, 3), the drawn glyph boxes [x1, y1, x2, y2])."""
    W, H = spec["page_width"], spec["page_height"]
    lo, hi = spec["glyph_px"]
    page = np.full((H, W, 3), 235, np.uint8)
    page += g.integers(0, 18, page.shape, dtype=np.uint8)
    boxes = []
    col_w = W // (n_cols + 1)
    for c in range(n_cols):
        x0 = W - (c + 1) * col_w - 20
        for r in range(chars_per_col):
            y0 = 40 + r * (H - 80) // chars_per_col
            w, h = int(g.integers(lo, hi)), int(g.integers(lo, hi))
            glyph = np.full((h, w, 3), 245, np.uint8)
            for _ in range(spec["strokes"]):
                sx, sy = int(g.integers(0, w - 8)), int(g.integers(0, h - 8))
                glyph[sy:sy + int(g.integers(4, h - sy)), sx:sx + int(g.integers(3, 8))] = g.integers(10, 60)
                glyph[sy:sy + int(g.integers(3, 8)), sx:sx + int(g.integers(4, w - sx))] = g.integers(10, 60)
            page[y0:y0 + h, x0:x0 + w] = glyph
            boxes.append([x0, y0, x0 + w, y0 + h])
    return page, boxes


def page_pool(spec: Dict, seed: int):
    """-> (pages, drawn boxes), batch b holding pages [b * batch, (b + 1) * batch)."""
    lay = layouts(spec)
    pages, boxes = [], []
    for b in range(spec["pool_batches"]):
        order = rng(seed, 1, b).permutation(len(lay))
        for j, k in enumerate(order):
            page, drawn = make_page(rng(seed, 2, b, j), *lay[k], spec)
            pages.append(page)
            boxes.append(drawn)
    return pages, boxes


# ------------------------------------------------------------------ e-IT samples


def sample_sizes(spec: Dict) -> List[Tuple[int, int]]:
    """(tiles, characters) of the samples of one pass, on an even grid over
    the traffic's ranges, shortest first."""
    n = spec["samples_per_pass"]
    tiles = np.rint(np.linspace(*spec["tiles"], n)).astype(int)
    chars = np.rint(np.linspace(*spec["chars"], n)).astype(int)
    return [(int(t), int(c)) for t, c in zip(tiles, chars)]


def eit_rows(spec: Dict, seed: int, prompt_ids, ignore: int = -100):
    """The micro-batches of the pool, each a list of ``batch`` samples of
    similar length (length-grouped: neighbours on the sorted grid), in an
    order drawn from the seed, pass after pass. A sample: ``prompt_ids(tiles,
    n_pseudo)`` (the chat prompt with its image and pseudo-token slots) then
    the page's text, ``chars`` token ids drawn from the seed, and the end of
    the turn; its labels are the text and the end of the turn. -> [[(ids,
    labels, tiles, chars)] a micro-batch]."""
    sizes = sample_sizes(spec)
    B = spec["batch"]
    groups = [sizes[i:i + B] for i in range(0, len(sizes), B)]
    lo, hi = spec["answer_ids"]
    out = []
    for p in range(spec["pool_passes"]):
        for gi in rng(seed, 3, p).permutation(len(groups)):
            mb = []
            for j, (t, c) in enumerate(groups[gi]):
                prompt = np.asarray(prompt_ids(t, 3 * c), np.int64)
                text = rng(seed, 4, p, int(gi), j).integers(lo, hi, c)
                answer = np.concatenate([text, [spec["end_of_turn_id"]]])
                ids = np.concatenate([prompt, answer])
                labels = np.concatenate([np.full(len(prompt), ignore), answer])
                mb.append((ids, labels, t, c))
            out.append(mb)
    return out

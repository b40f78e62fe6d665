"""Seeded test and benchmark corpora.

Every input the tests, ``bench.py`` and ``chip_smoke.py`` compress is
generated here from a seed, so no corpus file has to travel with the
repository:

  text(n, seed)          English-like verse: Zipf-distributed words from a
                         seeded vocabulary, punctuation and short lines
                         (stdlib zlib level 6 keeps roughly 40% of it);
  vertices(n, seed)      a binary vertex table: interleaved float32
                         position / normal / uv records of a smooth mesh;
  random_bytes(n, seed)  uniform bytes (incompressible);
  mixed(n, seed)         alternating text and random runs of 64 KiB to
                         1 MiB (exercises the stored-block choice).

``artifact(name)`` rebuilds the named files the codec's tests decode:
``simple.*`` and ``paradiselost.*`` (text) and ``vertices.deflate``,
with the compressed forms made by stdlib ``zlib``/``gzip``.
"""

from __future__ import annotations

import functools
import gzip
import io
import zlib

import numpy as np

_LETTERS = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
# English letter frequencies (percent) in _LETTERS order
_LETTER_P = np.array(
    [12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8, 2.8, 2.4,
     2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.15, 0.15, 0.1, 0.07]
)
_SEPS = [b" ", b", ", b". ", b"; ", b"\n", b",\n", b".\n"]
_SEP_P = np.array([0.80, 0.05, 0.02, 0.01, 0.09, 0.02, 0.01])
_VOCAB = 6000
_PIECE_WORDS = 1 << 18  # words generated per vectorized piece


@functools.lru_cache(maxsize=8)
def _vocabulary(seed: int):
    """(table bytes, starts, lengths) of the seeded vocabulary followed by
    the separators."""
    rng = np.random.default_rng([seed, 1])
    lens = np.clip(rng.geometric(0.24, _VOCAB), 1, 14)
    letters = rng.choice(_LETTERS, int(lens.sum()), p=_LETTER_P / _LETTER_P.sum())
    words = np.split(letters, np.cumsum(lens)[:-1])
    # a few capitalised words (names, line starts) as in verse
    for w in words[:: 23]:
        w[0] -= 32
    parts = [w.tobytes() for w in words] + _SEPS
    lengths = np.array([len(p) for p in parts], np.int64)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return np.frombuffer(b"".join(parts), np.uint8), starts, lengths


def text(n: int, seed: int = 0) -> bytes:
    """``n`` bytes of English-like text."""
    table, starts, lengths = _vocabulary(seed)
    rank = np.arange(_VOCAB, dtype=np.float64)
    p_word = 1.0 / (rank + 2.7) ** 1.07
    p_word /= p_word.sum()
    rng = np.random.default_rng([seed, 2])
    out, have = [], 0
    while have < n:
        ids = np.empty(2 * _PIECE_WORDS, np.int64)
        ids[0::2] = rng.choice(_VOCAB, _PIECE_WORDS, p=p_word)
        ids[1::2] = _VOCAB + rng.choice(len(_SEPS), _PIECE_WORDS, p=_SEP_P)
        ln = lengths[ids]
        ends = np.cumsum(ln)
        src = np.repeat(starts[ids] - (ends - ln), ln) + np.arange(ends[-1])
        piece = table[src]
        out.append(piece)
        have += len(piece)
    return np.concatenate(out)[:n].tobytes()


def vertices(n: int, seed: int = 0) -> bytes:
    """``n`` bytes of a vertex table: a seeded height-field grid emitted
    as a triangle list (two triangles per quad, no index buffer), each
    vertex 8 float32 (position, normal, uv)."""
    rng = np.random.default_rng([seed, 3])
    side = max(2, int(np.ceil(np.sqrt(n / 32 / 6))) + 1)
    g = np.arange(side, dtype=np.float32) / (side - 1)
    u, v = np.meshgrid(g, g, indexing="ij")
    a, b = rng.uniform(2, 6, 2)
    h = np.sin(a * np.pi * u) * np.cos(b * np.pi * v)
    hu = a * np.pi * np.cos(a * np.pi * u) * np.cos(b * np.pi * v)
    hv = -b * np.pi * np.sin(a * np.pi * u) * np.sin(b * np.pi * v)
    norm = np.sqrt(hu * hu + hv * hv + 1.0)
    rec = np.stack(
        [u * 10, h, v * 10, -hu / norm, 1.0 / norm, -hv / norm, u, v], axis=-1
    ).astype(np.float32).reshape(-1, 8)
    q = np.arange(side - 1)
    i, j = np.meshgrid(q, q, indexing="ij")
    c00 = (i * side + j).reshape(-1)
    c01, c10, c11 = c00 + 1, c00 + side, c00 + side + 1
    tris = np.stack([c00, c10, c01, c01, c10, c11], axis=1).reshape(-1)
    return rec[tris].tobytes()[:n]


def random_bytes(n: int, seed: int = 0) -> bytes:
    """``n`` uniform random bytes."""
    return np.random.default_rng([seed, 4]).integers(
        0, 256, n, dtype=np.uint8
    ).tobytes()


def mixed(n: int, seed: int = 0) -> bytes:
    """``n`` bytes alternating text and random runs of 64 KiB to 1 MiB."""
    rng = np.random.default_rng([seed, 5])
    parts, have, k = [], 0, 0
    while have < n:
        ln = int(rng.integers(1 << 16, 1 << 20))
        sub = int(rng.integers(1 << 30))
        parts.append(text(ln, sub) if k % 2 == 0 else random_bytes(ln, sub))
        have += ln
        k += 1
    return b"".join(parts)[:n]


_TEXT_LEN = 471162  # the size of the text corpus the tests were written for
_SIMPLE = (
    b"Hello, this is a simple text file.\n"
    b"It is compressed with deflate, zlib and gzip containers.\n"
)
_MTIME = 1262304000  # fixed gzip MTIME, so artifacts are reproducible


def _gzip(data: bytes, name: str) -> bytes:
    bio = io.BytesIO()
    with gzip.GzipFile(name, "wb", 6, bio, mtime=_MTIME) as f:
        f.write(data)
    return bio.getvalue()


@functools.lru_cache(maxsize=None)
def artifact(name: str) -> bytes:
    """The named corpus file (seed 0)."""
    if name == "simple.txt":
        return _SIMPLE
    if name == "simple.deflate":
        return zlib.compress(_SIMPLE, 6)
    if name == "simple.raw":
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        return c.compress(_SIMPLE) + c.flush()
    if name == "simple.gz":
        return _gzip(_SIMPLE, "simple.txt")
    if name == "paradiselost.txt":
        return text(_TEXT_LEN, 0)
    if name == "paradiselost.deflate":
        return zlib.compress(artifact("paradiselost.txt"), 6)
    if name == "paradiselost.gz":
        return _gzip(artifact("paradiselost.txt"), "paradiselost.txt")
    if name in ("paradiselost.part1.deflate", "paradiselost.part2.deflate"):
        wire = artifact("paradiselost.deflate")
        half = len(wire) // 2
        return wire[:half] if "part1" in name else wire[half:]
    if name == "vertices.deflate":
        return zlib.compress(vertices(320000, 0), 6)
    raise KeyError(name)

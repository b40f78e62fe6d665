"""Vectorized LSB-first bit stream assembly.

Redesign of the reference's serial bit packer (src/deflate.ts
send_bits/bi_flush/bi_windup :352-374,574-583): token codes become
(value, nbits) arrays; a prefix sum assigns every token its absolute bit
offset and three weighted bincounts scatter the (disjoint) bit
contributions into 32-bit words — O(log n)-depth, gather/scatter only,
which is exactly the shape the device bit-pack kernel uses.
"""

from __future__ import annotations

import numpy as np

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


class BitSink:
    """Accumulates (value, nbits) runs; assembles bytes on flush.

    Values are written LSB-first (DEFLATE bit order); each value must fit
    in its nbits (<= 56)."""

    def __init__(self, carry_val: int = 0, carry_bits: int = 0):
        self._vals: list[np.ndarray] = []
        self._nbits: list[np.ndarray] = []
        if carry_bits:
            self.push_scalar(carry_val, carry_bits)

    def push_scalar(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        self._vals.append(np.array([value], dtype=np.uint64))
        self._nbits.append(np.array([nbits], dtype=np.int64))

    def push(self, values: np.ndarray, nbits: np.ndarray) -> None:
        if len(values) == 0:
            return
        self._vals.append(values.astype(np.uint64))
        self._nbits.append(nbits.astype(np.int64))

    def push_bytes(self, byte_arr: np.ndarray) -> None:
        """Append a whole byte buffer (packed 4 bytes per value)."""
        n4 = (len(byte_arr) // 4) * 4
        if n4:
            words = byte_arr[:n4].view("<u4").astype(np.uint64)
            self.push(words, np.full(len(words), 32, np.int64))
        for b in byte_arr[n4:]:
            self.push_scalar(int(b), 8)

    def align_byte(self) -> None:
        total = int(sum(int(a.sum()) for a in self._nbits))
        pad = (-total) % 8
        if pad:
            self.push_scalar(0, pad)

    @property
    def total_bits(self) -> int:
        return int(sum(int(a.sum()) for a in self._nbits))

    def flush(self, final: bool = False):
        """Assemble whole bytes.  Returns (bytes_u8, carry_val, carry_bits);
        when final, pads the last partial byte with zero bits."""
        if not self._vals:
            return np.empty(0, dtype=np.uint8), 0, 0
        v = np.concatenate(self._vals)
        nb = np.concatenate(self._nbits)
        total = int(nb.sum())
        offsets = np.zeros(len(nb), dtype=np.int64)
        np.cumsum(nb[:-1], out=offsets[1:])

        nwords = (total >> 5) + 3
        idx = (offsets >> 5).astype(np.int64)
        sh = (offsets & 31).astype(np.uint64)
        lo = (v << sh) & _M64
        hi = np.where(sh > 0, v >> ((np.uint64(64) - sh) & np.uint64(63)), np.uint64(0))
        w0 = (lo & np.uint64(0xFFFFFFFF)).astype(np.float64)
        w1 = (lo >> np.uint64(32)).astype(np.float64)
        w2 = (hi & np.uint64(0xFFFFFFFF)).astype(np.float64)
        words = (
            np.bincount(idx, weights=w0, minlength=nwords)
            + np.bincount(idx + 1, weights=w1, minlength=nwords)
            + np.bincount(idx + 2, weights=w2, minlength=nwords)
        )
        words = words.astype(np.uint64).astype(np.uint32)
        all_bytes = words.astype("<u4").view(np.uint8)

        if final:
            nbytes = (total + 7) >> 3
            out = all_bytes[:nbytes].copy()
            self._vals, self._nbits = [], []
            return out, 0, 0
        nbytes = total >> 3
        carry_bits = total & 7
        carry_val = int(all_bytes[nbytes]) & ((1 << carry_bits) - 1) if carry_bits else 0
        out = all_bytes[:nbytes].copy()
        self._vals, self._nbits = [], []
        if carry_bits:
            self.push_scalar(carry_val, carry_bits)
        return out, carry_val, carry_bits

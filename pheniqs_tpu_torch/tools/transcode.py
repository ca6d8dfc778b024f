"""HTS container transcoder: BAM <-> CRAM.

The reference performs these conversions through htslib feeds inside
`pheniqs mux` (reference hts.cpp:160-240); this tool exposes the
framework's own codecs directly, including mapped records via
reference-based read features:

    python -m pheniqs_tpu_torch.tools.transcode in.bam out.cram --reference ref.fa
    python -m pheniqs_tpu_torch.tools.transcode in.cram out.bam --reference ref.fa
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="pheniqs-tpu-torch-transcode",
        description="transcode BAM <-> CRAM with the built-in codecs",
    )
    parser.add_argument("input", help="input .bam or .cram")
    parser.add_argument("output", help="output .cram or .bam")
    parser.add_argument(
        "--reference",
        help="reference FASTA (required for mapped records; falls back to"
        " $PHENIQS_CRAM_REFERENCE)",
    )
    parser.add_argument("--level", type=int, default=5)
    parser.add_argument(
        "--threads", type=int, default=None,
        help="BGZF deflate workers for BAM output (default: core count)",
    )
    arguments = parser.parse_args(argv)

    import os

    from ..io.cram import bam_to_cram, cram_to_bam

    threads = arguments.threads or os.cpu_count() or 1
    source = arguments.input.lower()
    target = arguments.output.lower()
    if source.endswith(".bam") and target.endswith(".cram"):
        count = bam_to_cram(
            arguments.input, arguments.output, arguments.reference,
            arguments.level,
        )
    elif source.endswith(".cram") and target.endswith(".bam"):
        count = cram_to_bam(
            arguments.input, arguments.output, arguments.reference,
            arguments.level, threads=threads,
        )
    else:
        parser.error("expected in.bam out.cram or in.cram out.bam")
        return 2
    sys.stderr.write(f"[pheniqs-tpu] transcoded {count} records\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

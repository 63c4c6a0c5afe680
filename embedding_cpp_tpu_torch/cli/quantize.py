"""Requantize a GGUF file.

    python -m embedding_cpp_tpu_torch.cli.quantize in.gguf out.gguf q4_0

The type is a name (q4_0 | q4_1 | q8_0 | f16 | f32) or the reference
quantizer's numeric code (2 = q4_0, 3 = q4_1; 7 = q8_0, ggml's code).
"""
from __future__ import annotations

import argparse

from ..models.quantize_tool import quantize_gguf

_NUMERIC = {"2": "q4_0", "3": "q4_1", "7": "q8_0"}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("type", help="q4_0 | q4_1 | q8_0 | f16 | f32 (or 2 | 3 | 7)")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)
    quantize_gguf(args.input, args.output, _NUMERIC.get(args.type, args.type),
                  verbose=not args.quiet)


if __name__ == "__main__":
    main()

"""Convert a local HF checkpoint directory to GGUF (or the legacy .bin).

    python -m embedding_cpp_tpu_torch.cli.convert <hf_model_dir> out.gguf --ftype f16

One step to q4_0 / q4_1 / q8_0 too; `--all-ftypes` writes every type into a
directory; `--legacy` writes the pre-GGUF .bin (f32 / f16), and a .bin
input is upgraded to GGUF.
"""
from __future__ import annotations

import argparse
import os

from ..models.convert import FTYPE_NAMES, convert_hf_dir, convert_hf_dir_to_legacy


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model_dir", help="local HF checkpoint directory, or a legacy "
                                     "ggml-model*.bin to upgrade to GGUF")
    p.add_argument("output", help="output .gguf path; with --all-ftypes, a directory "
                                  "receiving ggml-model-<ftype>.gguf")
    p.add_argument("--ftype", choices=sorted(FTYPE_NAMES), default=None,
                   help="default: f32 (gguf), f16 (--legacy), the input's (upgrade)")
    p.add_argument("--all-ftypes", action="store_true",
                   help="write f32, f16, q4_0, q4_1 and q8_0")
    p.add_argument("--legacy", action="store_true",
                   help="write the legacy pre-GGUF .bin format (f32/f16 only)")
    p.add_argument("--sparse", action=argparse.BooleanOptionalAction, default=None,
                   help="keep the MLM head for SPLADE sparse encoding "
                        "(default: detected from modules.json)")
    p.add_argument("--colbert", action=argparse.BooleanOptionalAction, default=None,
                   help="keep the ColBERT per-token projection and framing config "
                        "(default: detected from architectures / artifact.metadata)")
    args = p.parse_args(argv)
    upgrade = args.model_dir.endswith(".bin")
    for flag in ("sparse", "colbert"):
        if getattr(args, flag) and (args.legacy or upgrade):
            p.error(f"--{flag} applies to HF-dir -> GGUF conversion only")
    if args.all_ftypes and (args.legacy or upgrade):
        p.error("--all-ftypes applies to HF-dir -> GGUF conversion only "
                "(not --legacy output or .bin upgrades)")
    if args.legacy:
        convert_hf_dir_to_legacy(args.model_dir, args.output, args.ftype or "f16")
        print(f"wrote {args.output}")
    elif upgrade:
        from ..gguf.legacy import upgrade_legacy_bin

        upgrade_legacy_bin(args.model_dir, args.output, args.ftype)
        print(f"upgraded {args.model_dir} -> {args.output}")
    elif args.all_ftypes:
        os.makedirs(args.output, exist_ok=True)
        for ftype in ("f32", "f16", "q4_0", "q4_1", "q8_0"):
            out = os.path.join(args.output, f"ggml-model-{ftype}.gguf")
            convert_hf_dir(args.model_dir, out, ftype, sparse=args.sparse,
                           colbert=args.colbert)
            print(f"wrote {out}")
    else:
        convert_hf_dir(args.model_dir, args.output, args.ftype or "f32",
                       sparse=args.sparse, colbert=args.colbert)
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()

"""CLI: load a GGUF model, embed a prompt, print its tokens, the head of
its embedding and the load and eval times.

    python -m embedding_cpp_tpu_torch.cli.main -m m.gguf -p "hello world" [--device cpu]

The JAX package's `cli.main` (`-m/--model`, `-p/--prompt`, the prompt
options; `-t/--threads` is accepted and unused), plus `--device`: the GPU
by default, `cpu` runs the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-m", "--model", required=True, help="path to GGUF model")
    p.add_argument("-p", "--prompt", default="Hello world", help="prompt to embed")
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="(accepted for compatibility; unused)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the plain PyTorch "
                        "versions of the kernels)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--prompt-name", default=None,
                   help="named prompt prefix from the model's prompts (e.g. "
                        "query/passage); '' disables the default")
    p.add_argument("--prompt-prefix", default=None,
                   help="literal prefix put before the prompt (overrides --prompt-name)")
    args = p.parse_args(argv)

    from ..models.bert import ComputeOptions
    from ..runtime.engine import Engine
    from .engine_io import format_embedding

    t0 = time.perf_counter()
    engine = Engine.from_gguf(args.model, device=args.device,
                              opts=ComputeOptions(dtype=args.dtype))
    t_load = time.perf_counter() - t0

    prefix = engine.resolve_prompt(args.prompt_name, args.prompt_prefix)
    text = prefix + args.prompt
    if prefix:
        print(f"prompt prefix: {prefix!r}")

    ids = engine.tokenize(text)
    print(f"{len(ids)} tokens:")
    print("ids:", ids)
    print("tokens:", [engine.id_to_token(i) for i in ids])

    t1 = time.perf_counter()
    vec = engine.encode([text], prompt="")[0]
    t_eval = time.perf_counter() - t1

    print(format_embedding(vec))
    print(f"load time   = {t_load*1000:8.2f} ms")
    print(f"eval time   = {t_eval*1000:8.2f} ms (includes the kernels' build on first call)")

    t2 = time.perf_counter()
    engine.encode([text], prompt="")
    print(f"eval cached = {(time.perf_counter()-t2)*1000:8.2f} ms")


if __name__ == "__main__":
    main()

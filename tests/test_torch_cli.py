"""The port's CLIs on the CPU against the JAX package's on the same f32
GGUFs: `cli.main` prints the same token count, ids, tokens and prompt
prefix and an embedding head within 2e-5 (the head also equal to
`engine.encode`'s); `cli.rerank` prints the same ranking with scores within
2e-5 (sigmoid and raw), reads documents from a file and refuses a model
without a head; and `python -m ...cli.main` runs as a process."""
import re
import subprocess
import sys

import numpy as np
import pytest
from torch_native import ROOT, jax_native

from embedding_cpp_tpu_torch.cli import main as tmain
from embedding_cpp_tpu_torch.cli import rerank as trerank

ATOL = 2e-5
DOCS = ["the dog sat on the mat", "cats drink milk", "a lazy dog sleeps", "quick brown fox"]


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    from embedding_cpp_tpu_torch.cli.make_test_model import _preset_vocab, make_test_model
    from embedding_cpp_tpu_torch.models.convert import write_bert_gguf
    from embedding_cpp_tpu_torch.models.params import random_state_dict

    root = tmp_path_factory.mktemp("gguf")
    out = {}
    for preset in ("tiny", "tiny-reranker"):
        out[preset] = str(root / f"{preset}.gguf")
        make_test_model(out[preset], preset, "f32", seed=0)
    # tiny-nomic with nomic's prompts, "query" the default
    config, tokenizer_json = _preset_vocab("tiny-nomic")
    out["tiny-nomic"] = str(root / "tiny-nomic-prompts.gguf")
    write_bert_gguf(out["tiny-nomic"], config, random_state_dict(config, seed=0),
                    tokenizer_json, prompts={"query": "search_query: ",
                                             "document": "search_document: "},
                    default_prompt_name="query")
    return out


def _run(main, argv, capsys, monkeypatch, jax: bool) -> tuple[str, str]:
    if jax:  # the JAX CLIs read sys.argv
        monkeypatch.setattr(sys, "argv", ["prog", *argv])
        with jax_native("tokenizer"):
            main()
    else:
        main([*argv, "--device", "cpu"])
    out = capsys.readouterr()
    return out.out, out.err


def _head(out: str) -> np.ndarray:
    line = next(line for line in out.splitlines() if line.startswith("embedding["))
    return np.array([float(x) for x in re.findall(r"[-+]\d+\.\d+", line)], np.float32)


def _split(out: str) -> list[str]:
    """The lines other than the embedding head and the timings."""
    return [line for line in out.splitlines()
            if not line.startswith(("embedding[", "load time", "eval "))]


@pytest.mark.parametrize("preset,extra", [
    ("tiny", ["-p", "Hello world, the quick brown fox!"]),
    ("tiny", ["-p", "Café déjà vu " * 40]),
    ("tiny-nomic", ["-p", "what is a fox"]),
    ("tiny-nomic", ["-p", "what is a fox", "--prompt-name", "document"]),
    ("tiny-nomic", ["-p", "what is a fox", "--prompt-name", ""]),
    ("tiny-nomic", ["-p", "what is a fox", "--prompt-prefix", "custom: "]),
], ids=["tiny", "tiny-long", "nomic-default", "nomic-document", "nomic-none",
        "nomic-prefix"])
def test_main_matches_jax(ggufs, capsys, monkeypatch, preset, extra):
    from embedding_cpp_tpu.cli import main as jmain

    from embedding_cpp_tpu_torch import Engine

    argv = ["-m", ggufs[preset], *extra]
    ours, _ = _run(tmain.main, argv, capsys, monkeypatch, jax=False)
    theirs, _ = _run(jmain.main, argv, capsys, monkeypatch, jax=True)
    assert _split(ours) == _split(theirs)
    assert re.search(r"^\d+ tokens:$", ours, re.M)
    assert ("prompt prefix:" in ours) == (preset == "tiny-nomic" and "" not in extra)
    got = _head(ours)
    assert got.shape == (8,)
    np.testing.assert_allclose(got, _head(theirs), rtol=0, atol=ATOL)
    eng = Engine.from_gguf(ggufs[preset], device="cpu")
    args = dict(zip(extra[::2], extra[1::2]))
    prefix = eng.resolve_prompt(args.get("--prompt-name"), args.get("--prompt-prefix"))
    want = eng.encode([prefix + args["-p"]], prompt="")[0][:8]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)  # printed at 6 decimals


def _ranking(out: str) -> tuple[list[str], np.ndarray]:
    rows = [line.split(None, 1) for line in out.splitlines() if line.strip()]
    return [r[1] for r in rows], np.array([float(r[0]) for r in rows])


@pytest.mark.parametrize("extra", [[], ["--top-n", "2"], ["--raw-scores"]],
                         ids=["sigmoid", "top-n", "raw"])
def test_rerank_matches_jax(ggufs, capsys, monkeypatch, extra):
    from embedding_cpp_tpu.cli import rerank as jrerank

    argv = ["-m", ggufs["tiny-reranker"], "-q", "where is the dog",
            *[a for d in DOCS for a in ("-d", d)], *extra]
    ours, err = _run(trerank.main, argv, capsys, monkeypatch, jax=False)
    theirs, _ = _run(jrerank.main, argv, capsys, monkeypatch, jax=True)
    assert "rerank" in err and "load time" in err
    docs, scores = _ranking(ours)
    jdocs, jscores = _ranking(theirs)
    assert docs == jdocs and len(docs) == (2 if "--top-n" in extra else len(DOCS))
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=ATOL)


def test_rerank_reads_a_file_and_refuses_an_embedding_model(ggufs, capsys, tmp_path):
    docs = tmp_path / "docs.txt"
    docs.write_text("\n".join(DOCS) + "\n\n")
    trerank.main(["-m", ggufs["tiny-reranker"], "-q", "dog", "--docs-file", str(docs),
                  "-d", "one more", "--device", "cpu"])
    assert len(capsys.readouterr().out.splitlines()) == len(DOCS) + 1
    with pytest.raises(SystemExit):
        trerank.main(["-m", ggufs["tiny-reranker"], "-q", "dog", "--device", "cpu"])
    with pytest.raises(Exception, match="head|label"):
        trerank.main(["-m", ggufs["tiny"], "-q", "dog", "-d", "x", "--device", "cpu"])


def test_main_runs_as_a_module(ggufs):
    out = subprocess.run(
        [sys.executable, "-m", "embedding_cpp_tpu_torch.cli.main", "-m", ggufs["tiny"],
         "-p", "hello world", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert "ids: [2, " in out.stdout and "embedding[64] = [" in out.stdout

"""Head dims outside the attention kernels' instances, on the CPU: the
port's Engine against the JAX Engine where the head dim is 20 or 24
(ModernBERT and nomic-bert, packed rows at pack_seq 512 and 2048, which
take the long-row wrappers) and 96 (a BERT, plain and packed: the
projection-layout body's new instance), f32, seed 0, token lists made with
numpy, at the JAX package's 2e-5 bar.  Also: the route an unserved head
dim takes is counted in the wrapper's `plain_routes` and decided before
any launch, `attn_impl="kernel"` still raises there, the instance table
`HEAD_DIM_INSTANCES` names each CUDA source's D switch, and the shared
swizzle keeps every head dim's 16-byte chunks inside their row.

The card's side (K2/K3 at d 96 against their plain versions, a 384-wide
Engine of 4 heads, the d 24 route) is in tests/test_torch_cuda.py."""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from embedding_cpp_tpu.cli.make_test_model import PRESETS as JAX_PRESETS
from embedding_cpp_tpu.runtime.engine import Engine as JEngine
from embedding_cpp_tpu_torch import Engine
from embedding_cpp_tpu_torch.cli.make_test_model import PRESETS
from embedding_cpp_tpu_torch.models import ComputeOptions, bert_embed_batch, random_params
from embedding_cpp_tpu_torch.ops import attention as A
from embedding_cpp_tpu_torch.ops import deberta_attention as DA
from embedding_cpp_tpu_torch.ops.dispatch import kernel_impls

CSRC = Path(__file__).resolve().parents[1] / "embedding_cpp_tpu_torch" / "csrc"
ATOL = 2e-5  # the f32 bar of the JAX package's engine tests


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the test workers share the host's cores
    (as tests/test_torch_bench_scripts.py does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines(preset: str, e: int, h: int, n_ctx: int, **kw):
    """The port's CPU Engine and the JAX Engine over the same seed-0 f32
    weights of `preset` at width e with h heads."""
    shape = dict(n_embd=e, n_head=h, n_ctx=n_ctx)
    ours = Engine.synthetic(dataclasses.replace(PRESETS[preset], **shape), "f32", seed=0,
                            device="cpu", **kw)
    theirs = JEngine.synthetic(dataclasses.replace(JAX_PRESETS[preset], **shape), "f32",
                               seed=0, **kw)
    return ours, theirs


def _lists(lens, n_vocab: int, seed: int = 0) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [rng.integers(5, n_vocab, size=n).tolist() for n in lens]


def _routes() -> int:
    return sum(fn.plain_routes for fn in (
        A.flash_attention_bse, A.flash_attention_packed_bse, A.flash_attention,
        A.flash_attention_local, A.flash_attention_packed, A.flash_attention_packed_local))


# --- parity against the JAX Engine -----------------------------------------------------

@pytest.mark.parametrize("preset,e,h,pack_seq,lens", [
    ("tiny-modernbert", 48, 2, 2048, (12, 700, 1500)),  # d 24: K6 and mode 3's rows
    ("tiny-modernbert", 48, 2, 512, (12, 300, 500)),
    ("tiny-modernbert", 40, 2, 2048, (12, 700, 1500)),  # d 20
    ("tiny-modernbert", 40, 2, 512, (12, 300, 500)),
    ("tiny-nomic", 48, 2, 2048, (12, 700, 1500)),
    ("tiny-nomic", 40, 2, 512, (12, 300, 500)),
])
def test_unserved_head_dims_match_jax(preset, e, h, pack_seq, lens):
    """Packed "always": where the port raised `head dim 24 not in (16, 32,
    64, 128)` before the plain branch, it now returns the JAX Engine's
    embeddings, and every attention call took the counted plain route."""
    ours, theirs = _engines(preset, e, h, 2048, packing="always", pack_seq=pack_seq)
    lists = _lists(lens, ours.config.n_vocab, seed=e + pack_seq)
    before = _routes()
    got = ours.embed_tokens(lists)
    assert _routes() > before
    ref = theirs.embed_tokens(lists)
    assert got.shape == ref.shape == (len(lens), e)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("packing", ["always", "never"])
def test_bert_at_head_dim_96_matches_jax(packing):
    """A BERT of 2 heads of 96 (the projection-layout body's new instance):
    plain buckets and packed rows."""
    ours, theirs = _engines("tiny", 192, 2, 512, packing=packing)
    lists = _lists((12, 40, 100, 7), ours.config.n_vocab, seed=96)
    before = _routes()
    got = ours.embed_tokens(lists)
    assert _routes() == before  # d 96 has an instance: no plain route
    np.testing.assert_allclose(got, theirs.embed_tokens(lists), rtol=0, atol=ATOL)


# --- the route ---------------------------------------------------------------------

def _long_qkv(b, s, h, d, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=gen) for _ in range(3)]


def test_route_is_counted_and_kernel_still_raises():
    """At d 24 each wrapper counts its call in `plain_routes` under "auto"
    (decided from the shape: the CPU shows the card's route), not under
    "plain"; at d 16 it counts nothing; "kernel" raises, as it does for any
    CPU tensor."""
    q, k, v = _long_qkv(2, 64, 2, 24)
    seg = torch.zeros(2, 64, dtype=torch.int32)
    keyb = torch.zeros(2, 64)
    proj = [t.reshape(2, 64, 48) for t in (q, k, v)]
    calls = [
        (A.flash_attention, lambda: A.flash_attention(q, k, v, keyb)),
        (A.flash_attention_packed, lambda: A.flash_attention_packed(q, k, v, seg)),
        (A.flash_attention_packed_local,
         lambda: A.flash_attention_packed_local(q, k, v, seg, 16)),
        (A.flash_attention_bse, lambda: A.flash_attention_bse(*proj, keyb, 2)),
        (A.flash_attention_packed_bse, lambda: A.flash_attention_packed_bse(*proj, seg, 2)),
    ]
    for fn, call in calls:
        before, launches = fn.plain_routes, fn.launches
        call()
        assert (fn.plain_routes, fn.launches) == (before + 1, launches), fn.__name__
        with kernel_impls(attn="plain"):
            call()
        assert fn.plain_routes == before + 1, fn.__name__
        with kernel_impls(attn="kernel"), pytest.raises(ValueError):
            call()
    q16 = _long_qkv(2, 64, 2, 16)
    before = A.flash_attention.plain_routes
    A.flash_attention(*q16, keyb)
    assert A.flash_attention.plain_routes == before


def test_deberta_route_is_counted():
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 32, 2, 24, generator=gen) for _ in range(3))
    pk, pq = (torch.randn(16, 2, 24, generator=gen) for _ in range(2))
    before = DA.disentangled_attention.plain_routes
    out = DA.disentangled_attention(q, k, v, torch.zeros(2, 32), pk, pq, 8, 32)
    assert out.shape == q.shape
    assert DA.disentangled_attention.plain_routes == before + 1
    with kernel_impls(attn="kernel"), pytest.raises(ValueError):
        DA.disentangled_attention(q, k, v, torch.zeros(2, 32), pk, pq, 8, 32)


def test_forward_with_attn_kernel_at_head_dim_24_raises_on_the_cpu():
    """The Engine refuses "kernel" on the CPU when it is built; the
    forward itself raises at the first attention call, before any
    launch."""
    config = dataclasses.replace(PRESETS["tiny-modernbert"], n_embd=48, n_head=2)
    params = random_params(config, "f32", seed=0)
    ids = torch.from_numpy(np.asarray(_lists((30, 30), config.n_vocab)))
    mask = torch.ones_like(ids)
    assert bert_embed_batch(params, ids, mask, config).shape == (2, 48)
    with pytest.raises(ValueError, match="impl 'kernel'"):
        bert_embed_batch(params, ids, mask, config, ComputeOptions(attn_impl="kernel"))


def test_route_does_not_swallow_malformed_shapes():
    """A width that is no multiple of the heads is no head dim at all: it
    reaches the kernel branch's checks (which raise) on a CUDA tensor, and
    counts no plain route."""
    q = torch.zeros(1, 8, 50)
    assert A._served(q, A.HEAD_DIM_INSTANCES["attention_bse.cu"], 3)
    assert not A._served(q, A.HEAD_DIM_INSTANCES["attention_bse.cu"], 2)  # d 25
    assert A._served(torch.zeros(1, 8, 2, 96), A.HEAD_DIM_INSTANCES["attention_long.cu"]) \
        is False


# --- the instance table and the swizzle -----------------------------------------------

@pytest.mark.parametrize("source", sorted(A.HEAD_DIM_INSTANCES))
def test_instance_table_is_each_sources_switch(source):
    """HEAD_DIM_INSTANCES, the one table of head dims, is the D switch of
    each CUDA source's launch entry, read from the source."""
    dims = tuple(sorted(int(d) for d in re.findall(r"case (\d+): return",
                                                   (CSRC / source).read_text())))
    assert dims == A.HEAD_DIM_INSTANCES[source]
    assert not hasattr(DA, "HEAD_DIMS") and not hasattr(A, "HEAD_DIMS")


def _swizzle_rule():
    """[(condition, xor)] of sm90_mma.cuh's `swz`, read from the header."""
    body = re.search(r"int swz\(int r, int c\) \{(.*?)return", (CSRC / "sm90_mma.cuh")
                     .read_text(), re.S)[1]
    rule = re.findall(r"if constexpr \((.*?)\) \{\s*x = (.*?);", body)
    rule.append(("True", re.search(r"\} else \{\s*x = (.*?);", body)[1]))
    return rule


@pytest.mark.parametrize("d", sorted({16, 48, 80, 112, *A.HEAD_DIM_INSTANCES["attention_bse.cu"]}))
def test_swizzle_keeps_chunks_in_their_row(d):
    """For every d % 16 == 0 a body may be built for: each row's chunks map
    one to one onto the row's own chunks, and at d 96 the 8 rows of an
    ldmatrix phase fall in 8 distinct bank groups (d 64 and 128 too)."""
    cpr = d // 8
    rule = _swizzle_rule()

    def swz(r, c):
        for cond, x in rule:
            if eval(cond, {"CPR": cpr}):
                return r * cpr + (c ^ eval(x, {"r": r}))
        raise AssertionError("no branch")

    for r in range(16):
        assert sorted(swz(r, c) - r * cpr for c in range(cpr)) == list(range(cpr))
    if cpr % 4 == 0:
        for c in range(cpr):
            for r0 in (0, 8):
                assert len({swz(r, c) % 8 for r in range(r0, r0 + 8)}) == 8

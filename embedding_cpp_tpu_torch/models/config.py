"""Model hyperparameters for the BERT encoder path.

The BERT (`arch="bert"`) fields of the JAX package's `BertConfig`, read
from GGUF kv metadata the same way: n_vocab from the token list length,
everything else from `bert.*` keys.  Other encoder families are not ported
yet; a file that names one is refused instead of being run as BERT.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..gguf.constants import Keys

ARCH = "bert"


@dataclass(frozen=True)
class BertConfig:
    n_vocab: int
    n_ctx: int  # max tokens (bert.context_length)
    n_embd: int
    n_layer: int
    n_head: int
    n_ff: int
    layer_norm_eps: float = 1e-12
    n_token_types: int = 2
    gelu: str = "erf"  # "erf" (HF BertModel) | "tanh" (ggml's approximation)
    pooling: str = "mean"  # "mean" | "cls" | "max", then optional L2 norm
    normalize: bool = True
    # sentence-transformers Dense projection between pooling and the L2
    # norm (0 = none): pooled @ W.T + b, then `dense_activation`
    dense_out: int = 0
    dense_activation: str = "tanh"  # "tanh" | "identity"
    arch: str = ARCH
    pos_offset: int = 0
    name: str = ""

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def __post_init__(self):
        if self.n_embd % self.n_head:
            raise ValueError(
                f"n_embd {self.n_embd} not divisible by n_head {self.n_head}"
            )
        if self.arch != ARCH:
            raise NotImplementedError(
                f"architecture {self.arch!r} is not ported yet (only {ARCH!r})"
            )

    @classmethod
    def from_gguf_kv(cls, kv: dict) -> "BertConfig":
        return cls(
            n_vocab=len(kv[Keys.TOKENIZER_LIST]),
            n_ctx=int(kv[Keys.CONTEXT_LENGTH]),
            n_embd=int(kv[Keys.EMBEDDING_LENGTH]),
            n_layer=int(kv[Keys.BLOCK_COUNT]),
            n_head=int(kv[Keys.HEAD_COUNT]),
            n_ff=int(kv[Keys.FEED_FORWARD_LENGTH]),
            layer_norm_eps=float(kv.get(Keys.LAYER_NORM_EPS, 1e-12)),
            n_token_types=int(kv.get(Keys.TOKEN_TYPE_COUNT, 2)),
            gelu=str(kv.get(Keys.GELU, "erf")),
            pooling=str(kv.get(Keys.POOLING_TYPE, "mean")),
            normalize=bool(kv.get(Keys.NORMALIZE, True)),
            dense_out=int(kv.get(Keys.DENSE_OUT, 0)),
            dense_activation=str(kv.get(Keys.DENSE_ACTIVATION, "tanh")),
            # reference files say "bert" or nothing at all
            arch=str(kv.get(Keys.ARCHITECTURE, ARCH)),
            pos_offset=int(kv.get(Keys.POSITION_OFFSET, 0)),
            name=str(kv.get(Keys.NAME, "")),
        )


# all-MiniLM-L6-v2 geometry (synthetic benchmarking without downloads)
MINILM_L6 = BertConfig(
    n_vocab=30522, n_ctx=512, n_embd=384, n_layer=6, n_head=12, n_ff=1536,
    name="all-MiniLM-L6-v2",
)

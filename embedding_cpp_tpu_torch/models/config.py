"""Model hyperparameters of every encoder family of the JAX package.

The BERT-graph families (`arch` "bert", "roberta" with XLM-R, "distilbert",
"electra", "mpnet" and "albert"), the T5 encoder (`arch="t5"`), ModernBERT
(`arch="modernbert"`), DeBERTa-v3 (`arch="deberta"`) and nomic-bert
(`arch="nomic-bert"`) fields of the JAX package's `BertConfig`, read from
GGUF kv metadata the same way: n_vocab from the token list length,
everything else from `bert.*` keys, with per-family defaults for the keys a
file leaves out.  An architecture name the reference does not know
("xlm-roberta", "jina-bert-v2", ...) reads as BERT, as the reference reads
it.  `from_hf_config` reads a transformers config.json with the JAX
package's per-family rules (the converter's input), `arch_defaults` fills
a family's defaults.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..gguf.constants import Keys

ARCH = "bert"
# per-family defaults: (n_token_types, pos_offset, layer_norm_eps,
# rel_attn_buckets).  RoBERTa (and XLM-R) numbers real tokens from
# padding_idx + 1 = 2, has a 1-row token-type table and eps 1e-5;
# DistilBERT has no token-type table; ELECTRA is BERT's graph and names.
# MPNet numbers positions as RoBERTa does, has no token-type table, eps
# 1e-5 and a 32-bucket T5-style relative bias shared by every layer;
# ALBERT is BERT's graph with one shared layer (gelu_tanh, factorized
# tables).  T5 has no token-type or position table, RMSNorm eps 1e-6 and
# the 32-bucket relative bias.  ModernBERT has no token-type or position
# table (RoPE), and eps 1e-5 (HF ModernBertConfig); DeBERTa-v3 has neither
# table either (relative positions only), eps 1e-7 and 256 position
# buckets; nomic-bert keeps BERT's two token types and eps, and rotates
# (RoPE) instead of a position table
_ARCH_DEFAULTS = {"bert": (2, 0, 1e-12, 0), "roberta": (1, 2, 1e-5, 0),
                  "distilbert": (0, 0, 1e-12, 0), "mpnet": (0, 2, 1e-5, 32),
                  "modernbert": (0, 0, 1e-5, 0), "albert": (2, 0, 1e-12, 0),
                  "electra": (2, 0, 1e-12, 0), "t5": (0, 0, 1e-6, 32),
                  "deberta": (0, 0, 1e-7, 256), "nomic-bert": (2, 0, 1e-12, 0)}
# the families whose embeddings add an absolute-position table and run
# BERT's post-norm block (models/bert.py)
BERT_GRAPH_ARCHS = ("bert", "roberta", "distilbert", "electra", "mpnet", "albert")
# the reference's families the port does not serve yet: none
UNPORTED_ARCHS: tuple[str, ...] = ()
# classification-head activation per family: DistilBERT's pre_classifier
# uses ReLU; ELECTRA's ClassificationHead, DeBERTa's ContextPooler and
# ModernBERT's PredictionHead GELU; BERT's pooler and RoBERTa's head tanh
HEAD_ACT_DEFAULTS = {"distilbert": "relu", "modernbert": "gelu", "electra": "gelu",
                     "deberta": "gelu"}


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
    # DeBERTa: log-bucketed relative positions, linear within
    # +-rel_attn_buckets/2 and log-spaced out to rel_attn_max_dist; one
    # [2*rel_attn_buckets, E] table shared by every layer
    rel_attn_buckets: int = 0
    rel_attn_max_dist: int = 128
    # ModernBERT (unused by BERT): layer i is global when
    # i % global_attn_every == 0 and rotates by RoPE base rope_theta; every
    # other layer attends within |q - k| <= local_window // 2 and rotates by
    # local_rope_theta (rope_theta when 0)
    rope_theta: float = 0.0
    local_rope_theta: float = 0.0
    global_attn_every: int = 0
    local_window: int = 0
    # nomic-bert: dynamic-NTK RoPE scaling once the sequence length S
    # exceeds rope_max_trained (factor > 0): base' = base * ((factor * S /
    # max_trained) - (factor - 1)) ** (d / (d - 2)); attn_bias / ffn_bias
    # say whether the Wqkv + out_proj / fc11 + fc12 + fc2 linears carry
    # biases (published checkpoints have none)
    rope_scaling_factor: float = 0.0
    rope_max_trained: int = 0
    attn_bias: bool = True
    ffn_bias: bool = True
    # sequence-classification head (cross-encoder rerankers; 0 = embedding
    # model): logits = out(act(dense(h_cls))), act one of tanh/relu/gelu
    n_labels: int = 0
    head_activation: str = "tanh"
    # factorized embedding-table width (ALBERT's and ELECTRA-small's
    # embedding_size 128; 0 = the tables are n_embd wide): the tables and
    # the embedding LayerNorm live at this width, and the emb_proj linear
    # maps the normalized embeddings to n_embd before layer 0
    n_embd_emb: int = 0
    # T5: the per-head width d_kv where it is not n_embd // n_head (q/k/v
    # map n_embd -> n_head * n_head_dim); the FFN activation ("relu",
    # "gelu_erf" or "gelu_tanh"; "" the family's GELU) and whether it is
    # gated, act(wi_0 x) * wi_1 x
    n_head_dim: int = 0
    ffn_act: str = ""
    ffn_gated: bool = False
    # SPLADE sparse encoder (bert, roberta, distilbert): the MLM prediction
    # head, its decoder tied to the word table; the model emits |V|-wide
    # sparse vectors, max over tokens of log1p(relu(logits))
    mlm_head: bool = False
    # ColBERT (colbert_dim > 0, the width of the bias-free per-token
    # projection): queries frame [CLS] [Q] .. [SEP] padded with [MASK] to
    # query_maxlen (not attended to, but scored), documents [CLS] [D] ..
    # [SEP]; mask_punctuation drops punctuation tokens from document
    # scoring; the marker and mask ids come from the file
    colbert_dim: int = 0
    query_maxlen: int = 32
    mask_punctuation: bool = True
    q_marker_id: int = -1
    d_marker_id: int = -1
    mask_id: int = -1
    name: str = ""

    @property
    def head_dim(self) -> int:
        return self.n_head_dim or self.n_embd // self.n_head

    @property
    def attn_inner(self) -> int:
        """Width of the q/k/v projections (n_embd unless d_kv differs)."""
        return self.n_head * self.head_dim

    @property
    def shared_layers(self) -> bool:
        """True when one parameter set serves every layer (ALBERT): the
        layer stack has leading dim 1, applied n_layer times."""
        return self.arch == "albert"

    @property
    def abs_positions(self) -> bool:
        """Whether the embeddings add an absolute-position table: the
        BERT-graph families do (MPNet beside its relative bias); ModernBERT
        and nomic-bert rotate (RoPE), DeBERTa and T5 attend relatively."""
        return self.arch in BERT_GRAPH_ARCHS

    @property
    def emb_width(self) -> int:
        """Width of the embedding tables (n_embd unless factorized)."""
        return self.n_embd_emb or self.n_embd

    def __post_init__(self):
        if not self.n_head_dim and self.n_embd % self.n_head:
            raise ValueError(
                f"n_embd {self.n_embd} not divisible by n_head {self.n_head}"
            )
        if self.arch not in _ARCH_DEFAULTS:
            raise ValueError(f"unsupported architecture {self.arch!r} "
                             f"(supported: {sorted(_ARCH_DEFAULTS)})")
        if self.n_labels and self.head_activation not in ("tanh", "relu", "gelu"):
            raise ValueError(f"unsupported head_activation {self.head_activation!r} "
                             "(supported: tanh, relu, gelu)")
        if self.n_embd_emb and self.arch not in ("albert", "electra"):
            raise ValueError("factorized embeddings (n_embd_emb) are only supported for "
                             f"albert/electra, not {self.arch!r}")
        if self.mlm_head and self.arch not in ("bert", "roberta", "distilbert"):
            raise ValueError("mlm_head (SPLADE sparse encoding) is only supported for "
                             f"bert/roberta/distilbert, not {self.arch!r}")
        if self.colbert_dim:
            if self.arch == "t5":
                raise ValueError("colbert_dim needs a CLS-framed family, not t5")
            if self.mlm_head or self.n_labels or self.dense_out:
                raise ValueError("colbert_dim is exclusive with mlm_head / n_labels / "
                                 "dense_out (a ColBERT checkpoint has exactly the "
                                 "per-token projection head)")
            if min(self.q_marker_id, self.d_marker_id, self.mask_id) < 0:
                raise ValueError("ColBERT models need q_marker_id, d_marker_id and "
                                 "mask_id (resolved from the tokenizer at conversion)")
            if self.query_maxlen < 4:
                raise ValueError(f"query_maxlen {self.query_maxlen} leaves no room for "
                                 "[CLS] [Q] token [SEP]")

    @classmethod
    def arch_defaults(cls, arch: str, **kw) -> "BertConfig":
        """A config with the family's token-type, position-offset, eps and
        bucket defaults (and ALBERT's tanh GELU) for the fields `kw` leaves
        out."""
        ntt, off, eps, buckets = _ARCH_DEFAULTS[arch]
        kw.setdefault("n_token_types", ntt)
        kw.setdefault("pos_offset", off)
        kw.setdefault("layer_norm_eps", eps)
        kw.setdefault("rel_attn_buckets", buckets)
        if arch == "albert":
            kw.setdefault("gelu", "tanh")
        return cls(arch=arch, **kw)

    @classmethod
    def from_gguf_kv(cls, kv: dict) -> "BertConfig":
        # reference files say "bert" or nothing at all; a name the reference
        # does not know reads as BERT there too
        arch = str(kv.get(Keys.ARCHITECTURE, ARCH))
        if arch not in _ARCH_DEFAULTS:
            arch = ARCH
        ntt, off, eps, buckets = _ARCH_DEFAULTS[arch]
        # the nomic-bert forward is SwiGLU: refuse a file that declares
        # another FFN rather than serve it as one
        ffn = (str(kv.get(Keys.FFN_ACT, "silu")), bool(kv.get(Keys.FFN_GATED, True)))
        if arch == "nomic-bert" and ffn != ("silu", True):
            raise NotImplementedError(f"nomic-bert FFN {ffn[0]!r} (gated {ffn[1]}) is not "
                                      "ported: only the gated silu (SwiGLU) is")
        return cls(
            n_vocab=len(kv[Keys.TOKENIZER_LIST]),
            n_ctx=int(kv[Keys.CONTEXT_LENGTH]),
            n_embd=int(kv[Keys.EMBEDDING_LENGTH]),
            n_layer=int(kv[Keys.BLOCK_COUNT]),
            n_head=int(kv[Keys.HEAD_COUNT]),
            n_ff=int(kv[Keys.FEED_FORWARD_LENGTH]),
            layer_norm_eps=float(kv.get(Keys.LAYER_NORM_EPS, eps)),
            n_token_types=int(kv.get(Keys.TOKEN_TYPE_COUNT, ntt)),
            gelu=str(kv.get(Keys.GELU, "tanh" if arch == "albert" else "erf")),
            pooling=str(kv.get(Keys.POOLING_TYPE, "mean")),
            normalize=bool(kv.get(Keys.NORMALIZE, True)),
            dense_out=int(kv.get(Keys.DENSE_OUT, 0)),
            dense_activation=str(kv.get(Keys.DENSE_ACTIVATION, "tanh")),
            arch=arch,
            pos_offset=int(kv.get(Keys.POSITION_OFFSET, off)),
            rel_attn_buckets=int(kv.get(Keys.REL_ATTN_BUCKETS, buckets)),
            rel_attn_max_dist=int(kv.get(Keys.REL_ATTN_MAX_DIST, 128)),
            rope_theta=float(kv.get(Keys.ROPE_FREQ_BASE, 0.0)),
            local_rope_theta=float(kv.get(Keys.ROPE_FREQ_BASE_LOCAL, 0.0)),
            global_attn_every=int(kv.get(Keys.GLOBAL_ATTN_EVERY, 0)),
            local_window=int(kv.get(Keys.LOCAL_ATTN_WINDOW, 0)),
            rope_scaling_factor=float(kv.get(Keys.ROPE_SCALING_FACTOR, 0.0)),
            rope_max_trained=int(kv.get(Keys.ROPE_MAX_TRAINED, 0)),
            attn_bias=bool(kv.get(Keys.ATTN_BIAS, arch != "nomic-bert")),
            ffn_bias=bool(kv.get(Keys.FFN_BIAS, arch != "nomic-bert")),
            n_labels=int(kv.get(Keys.N_LABELS, 0)),
            head_activation=str(kv.get(Keys.HEAD_ACTIVATION,
                                       HEAD_ACT_DEFAULTS.get(arch, "tanh"))),
            n_embd_emb=int(kv.get(Keys.EMB_WIDTH, 0)),
            n_head_dim=int(kv.get(Keys.HEAD_DIM, 0)),
            ffn_act=str(kv.get(Keys.FFN_ACT, "relu" if arch == "t5" else "")),
            ffn_gated=bool(kv.get(Keys.FFN_GATED, False)),
            mlm_head=bool(kv.get(Keys.MLM_HEAD, False)),
            colbert_dim=int(kv.get(Keys.COLBERT_DIM, 0)),
            query_maxlen=int(kv.get(Keys.COLBERT_QUERY_MAXLEN, 32)),
            mask_punctuation=bool(kv.get(Keys.COLBERT_MASK_PUNCT, True)),
            q_marker_id=int(kv.get(Keys.COLBERT_Q_MARKER, -1)),
            d_marker_id=int(kv.get(Keys.COLBERT_D_MARKER, -1)),
            mask_id=int(kv.get(Keys.COLBERT_MASK_ID, -1)),
            name=str(kv.get(Keys.NAME, "")),
        )

    @classmethod
    def from_hf_config(cls, hf: dict, name: str = "") -> "BertConfig":
        """From a transformers config.json dict, dispatched on model_type,
        with the per-family rules of the JAX package's converter: a family
        knob no published checkpoint sets is refused, not ignored."""
        model_type = str(hf.get("model_type", "bert"))
        reader = _HF_READERS.get(model_type)
        if reader is not None:
            return reader(cls, hf, name)
        if model_type in ("roberta", "xlm-roberta", "camembert"):
            # positions numbered from padding_idx + 1; the usable context
            # leaves out those rows
            pos_offset = int(hf.get("pad_token_id", 1)) + 1
            return cls(**_hf_common(hf, "max_position_embeddings", 514, pos_offset),
                       layer_norm_eps=float(hf.get("layer_norm_eps", 1e-5)),
                       n_token_types=int(hf.get("type_vocab_size", 1)), arch="roberta",
                       pos_offset=pos_offset, name=name)
        return cls(**_hf_common(hf, "max_position_embeddings", 512),
                   layer_norm_eps=float(hf.get("layer_norm_eps", 1e-12)),
                   n_token_types=int(hf.get("type_vocab_size", 2)), name=name)


def _hf_common(hf: dict, ctx_key: str, ctx_default: int, ctx_less: int = 0) -> dict:
    """The BertConfig-named geometry of a config.json (hidden_size, ...)."""
    return dict(n_vocab=int(hf["vocab_size"]),
                n_ctx=int(hf.get(ctx_key, ctx_default)) - ctx_less,
                n_embd=int(hf["hidden_size"]), n_layer=int(hf["num_hidden_layers"]),
                n_head=int(hf["num_attention_heads"]), n_ff=int(hf["intermediate_size"]))


def _hf_distilbert(cls, hf: dict, name: str) -> BertConfig:
    # HF modeling_distilbert fixes the LayerNorm eps at 1e-12
    return cls(n_vocab=int(hf["vocab_size"]),
               n_ctx=int(hf.get("max_position_embeddings", 512)), n_embd=int(hf["dim"]),
               n_layer=int(hf["n_layers"]), n_head=int(hf["n_heads"]),
               n_ff=int(hf["hidden_dim"]), layer_norm_eps=1e-12, n_token_types=0,
               arch="distilbert", name=name)


def _hf_mpnet(cls, hf: dict, name: str) -> BertConfig:
    # MPNetEmbeddings fixes padding_idx at 1, so positions start at 2; the
    # relative bias is T5-bucketed (32 buckets in every checkpoint)
    return cls(**_hf_common(hf, "max_position_embeddings", 514, 2),
               layer_norm_eps=float(hf.get("layer_norm_eps", 1e-12)), n_token_types=0,
               arch="mpnet", pos_offset=2,
               rel_attn_buckets=int(hf.get("relative_attention_num_buckets", 32)), name=name)


def _hf_modernbert(cls, hf: dict, name: str) -> BertConfig:
    # bias-free linears and norms and a GELU MLP are the only published
    # configuration: refuse the others rather than drop weights
    if any(bool(hf.get(k, False)) for k in ("attention_bias", "mlp_bias", "norm_bias")):
        raise ValueError("modernbert with attention_bias/mlp_bias/norm_bias=True "
                         "is not supported (no published checkpoint uses biases)")
    if str(hf.get("hidden_activation", "gelu")) != "gelu":
        raise ValueError(f"modernbert hidden_activation {hf.get('hidden_activation')!r} "
                         "!= 'gelu' unsupported")
    local_theta = hf.get("local_rope_theta")  # None: the global theta
    return cls(**_hf_common(hf, "max_position_embeddings", 8192),
               layer_norm_eps=float(hf.get("norm_eps", 1e-5)), n_token_types=0,
               arch="modernbert", rope_theta=float(hf.get("global_rope_theta", 160000.0)),
               local_rope_theta=float(local_theta if local_theta is not None else 0.0),
               global_attn_every=int(hf.get("global_attn_every_n_layers", 3)),
               local_window=int(hf.get("local_attention", 128)), name=name)


def _hf_t5(cls, hf: dict, name: str) -> BertConfig:
    # feed_forward_proj "relu" (T5, sentence-t5, GTR) or "gated-<act>"
    # (v1.1, flan); exactly "gated-gelu" means gelu_new (the tanh form) for
    # HF's back-compat, a plain "gelu" the erf form
    ff_proj = str(hf.get("feed_forward_proj", "relu"))
    gated = ff_proj.startswith("gated-")
    act = ff_proj.removeprefix("gated-")
    if act not in ("relu", "gelu", "gelu_new"):
        raise ValueError(f"unsupported t5 feed_forward_proj {ff_proj!r}")
    if act == "gelu_new" or ff_proj == "gated-gelu":
        ffn_act = "gelu_tanh"
    else:
        ffn_act = "gelu_erf" if act == "gelu" else "relu"
    # no position table: n_positions records the trained length
    return cls(n_vocab=int(hf["vocab_size"]), n_ctx=int(hf.get("n_positions", 512)),
               n_embd=int(hf["d_model"]), n_layer=int(hf["num_layers"]),
               n_head=int(hf["num_heads"]), n_ff=int(hf["d_ff"]),
               layer_norm_eps=float(hf.get("layer_norm_epsilon", 1e-6)), n_token_types=0,
               arch="t5", rel_attn_buckets=int(hf.get("relative_attention_num_buckets", 32)),
               rel_attn_max_dist=int(hf.get("relative_attention_max_distance", 128)),
               n_head_dim=int(hf.get("d_kv", 64)), ffn_act=ffn_act, ffn_gated=gated,
               name=name)


def _hf_deberta(cls, hf: dict, name: str) -> BertConfig:
    # the v3 feature set only: relative attention with shared keys, no
    # absolute positions or conv layer, LayerNormed relative embeddings,
    # c2p + p2c, embedding_size == hidden_size, log buckets
    refusals = (
        (not bool(hf.get("relative_attention", False)),
         "deberta-v2 without relative_attention is not supported"),
        (not bool(hf.get("share_att_key", False)),
         "deberta-v2 with share_att_key=False is not supported (v3 checkpoints share)"),
        (bool(hf.get("position_biased_input", True)),
         "deberta-v2 with position_biased_input (absolute positions) is not supported"),
        (int(hf.get("conv_kernel_size", 0)) > 0, "deberta-v2 conv layer is not supported"),
        ("layer_norm" not in str(hf.get("norm_rel_ebd", "none")),
         "deberta-v2 without norm_rel_ebd=layer_norm is not supported"),
    )
    for bad, why in refusals:
        if bad:
            raise ValueError(why)
    pos_att = str(hf.get("pos_att_type", "p2c|c2p"))
    if "c2p" not in pos_att or "p2c" not in pos_att:
        raise ValueError(f"pos_att_type {pos_att!r} != c2p+p2c is not supported")
    if int(hf.get("embedding_size") or hf["hidden_size"]) != int(hf["hidden_size"]):
        raise ValueError("deberta-v2 embedding_size != hidden_size is not supported")
    n_ctx = int(hf.get("max_position_embeddings", 512))
    max_rel = int(hf.get("max_relative_positions", -1))
    buckets = int(hf.get("position_buckets", 256))
    if buckets <= 0:
        raise ValueError("deberta-v2 without position_buckets is not supported")
    return cls(**_hf_common(hf, "max_position_embeddings", 512),
               layer_norm_eps=float(hf.get("layer_norm_eps", 1e-7)),
               n_token_types=int(hf.get("type_vocab_size", 0)), arch="deberta",
               rel_attn_buckets=buckets, rel_attn_max_dist=max_rel if max_rel > 0 else n_ctx,
               name=name)


def _hf_albert(cls, hf: dict, name: str) -> BertConfig:
    # every published checkpoint has one layer group of one layer
    if int(hf.get("num_hidden_groups", 1)) != 1 or int(hf.get("inner_group_num", 1)) != 1:
        raise ValueError("albert with num_hidden_groups/inner_group_num != 1 is not "
                         "supported (no published checkpoint uses them)")
    act = str(hf.get("hidden_act", "gelu_new"))
    if act not in ("gelu_new", "gelu"):
        raise ValueError(f"unsupported albert hidden_act {act!r}")
    return cls(**_hf_common(hf, "max_position_embeddings", 512),
               layer_norm_eps=float(hf.get("layer_norm_eps", 1e-12)),
               n_token_types=int(hf.get("type_vocab_size", 2)), arch="albert",
               gelu="tanh" if act == "gelu_new" else "erf",
               n_embd_emb=int(hf.get("embedding_size", 128)), name=name)


def _hf_electra(cls, hf: dict, name: str) -> BertConfig:
    # BertModel's graph; the tables are factorized only where embedding_size
    # differs from hidden_size (embeddings_project exists only then)
    emb_size = int(hf.get("embedding_size", hf["hidden_size"]))
    return cls(**_hf_common(hf, "max_position_embeddings", 512),
               layer_norm_eps=float(hf.get("layer_norm_eps", 1e-12)),
               n_token_types=int(hf.get("type_vocab_size", 2)), arch="electra",
               n_embd_emb=0 if emb_size == int(hf["hidden_size"]) else emb_size, name=name)


def _hf_nomic(cls, hf: dict, name: str) -> BertConfig:
    # modeling_hf_nomic_bert.py: SwiGLU, full rotate-half RoPE, post-norm
    # LayerNorm blocks; the knobs no published checkpoint sets are refused
    refusals = (
        (str(hf.get("activation_function", "swiglu")) != "swiglu",
         f"nomic_bert activation_function {hf.get('activation_function')!r} != 'swiglu' "
         "is not supported (every published nomic-embed/nomic-bert checkpoint is SwiGLU)"),
        (float(hf.get("rotary_emb_fraction", 0.0)) != 1.0,
         "nomic_bert needs rotary_emb_fraction == 1.0 (partial rotary / absolute-position "
         "variants unsupported)"),
        (bool(hf.get("rotary_emb_interleaved", False)),
         "nomic_bert rotary_emb_interleaved=True is not supported (published checkpoints "
         "use rotate-half)"),
        (bool(hf.get("causal", False)) or bool(hf.get("prenorm", False)),
         "nomic_bert with causal or prenorm set is not supported"),
        (bool(hf.get("use_rms_norm", False)), "nomic_bert use_rms_norm is not supported"),
        (bool(hf.get("mlp_fc1_bias", True)) != bool(hf.get("mlp_fc2_bias", True)),
         "nomic_bert with mixed mlp_fc1_bias/mlp_fc2_bias is not supported"),
    )
    for bad, why in refusals:
        if bad:
            raise ValueError(why)
    return cls(n_vocab=int(hf["vocab_size"]), n_ctx=int(hf.get("n_positions", 2048)),
               n_embd=int(hf["n_embd"]), n_layer=int(hf["n_layer"]), n_head=int(hf["n_head"]),
               n_ff=int(hf["n_inner"]), layer_norm_eps=float(hf.get("layer_norm_epsilon", 1e-12)),
               n_token_types=int(hf.get("type_vocab_size", 2)), arch="nomic-bert",
               rope_theta=float(hf.get("rotary_emb_base", 1000.0)),
               rope_scaling_factor=float(hf.get("rotary_scaling_factor") or 0.0),
               rope_max_trained=int(hf.get("max_trained_positions", 2048)),
               ffn_act="silu", ffn_gated=True, attn_bias=bool(hf.get("qkv_proj_bias", True)),
               ffn_bias=bool(hf.get("mlp_fc1_bias", True)), name=name)


# config.json model_type -> reader (the BERT and RoBERTa graphs inline above)
_HF_READERS = {"distilbert": _hf_distilbert, "mpnet": _hf_mpnet,
               "modernbert": _hf_modernbert, "t5": _hf_t5, "deberta-v2": _hf_deberta,
               "albert": _hf_albert, "electra": _hf_electra, "nomic_bert": _hf_nomic}


# all-MiniLM-L6-v2 geometry (synthetic benchmarking without downloads)
MINILM_L6 = BertConfig(
    n_vocab=30522, n_ctx=512, n_embd=384, n_layer=6, n_head=12, n_ff=1536,
    name="all-MiniLM-L6-v2",
)
# all-MiniLM-L12-v2 and bert-base-uncased geometry (synthetic presets)
MINILM_L12 = BertConfig(
    n_vocab=30522, n_ctx=512, n_embd=384, n_layer=12, n_head=12, n_ff=1536,
    name="all-MiniLM-L12-v2",
)
BERT_BASE = BertConfig(
    n_vocab=30522, n_ctx=512, n_embd=768, n_layer=12, n_head=12, n_ff=3072,
    name="bert-base-uncased",
)
# BAAI/bge-large-en-v1.5 geometry (BertModel, CLS pooling, normalized),
# which mxbai-embed-large-v1 shares and e5-large-v2 shares with mean
# pooling: 24 layers of 1024, 16 heads of 64, FFN 4096.  In Q8_0 its FFN
# weights are too large for the fused kernel's 1-D route (ops/q4_matmul.py)
BGE_LARGE_EN = BertConfig(
    n_vocab=30522, n_ctx=512, n_embd=1024, n_layer=24, n_head=16, n_ff=4096,
    layer_norm_eps=1e-12, gelu="erf", pooling="cls", name="bge-large-en-v1.5",
)
# answerdotai/ModernBERT-base geometry, which gte-modernbert-base reuses
# (gte pools cls): 22 layers, GeGLU FFN 1152, global attention every 3rd
# layer, a 128-token sliding window elsewhere, 8192-token context
MODERNBERT_BASE = BertConfig(
    n_vocab=50368, n_ctx=8192, n_embd=768, n_layer=22, n_head=12, n_ff=1152,
    n_token_types=0, arch="modernbert", layer_norm_eps=1e-5,
    rope_theta=160000.0, local_rope_theta=10000.0,
    global_attn_every=3, local_window=128, pooling="cls",
    name="gte-modernbert-base",
)
# microsoft/deberta-v3-base geometry, the encoder of mxbai-rerank-base-v1
# and nli-deberta-v3-base: 12 layers, 256 position buckets out to 512
DEBERTA_V3_BASE = BertConfig(
    n_vocab=128100, n_ctx=512, n_embd=768, n_layer=12, n_head=12, n_ff=3072,
    n_token_types=0, arch="deberta", layer_norm_eps=1e-7,
    rel_attn_buckets=256, rel_attn_max_dist=512,
    name="deberta-v3-base",
)
# nomic-ai/nomic-embed-text-v1.5 geometry (NomicBertModel): post-norm RoPE
# blocks (base 1000), SwiGLU FFN 3072, bias-free attention and FFN
# linears, dynamic-NTK scaling past the 2048 trained positions up to the
# 8192-token context
NOMIC_EMBED = BertConfig(
    n_vocab=30528, n_ctx=8192, n_embd=768, n_layer=12, n_head=12, n_ff=3072,
    arch="nomic-bert", rope_theta=1000.0, rope_scaling_factor=2.0,
    rope_max_trained=2048, ffn_act="silu", ffn_gated=True,
    attn_bias=False, ffn_bias=False,
    name="nomic-embed-text-v1.5",
)
# intfloat/multilingual-e5-base geometry (XLMRobertaModel, the encoder of
# paraphrase-multilingual-mpnet-base-v2 and bge-reranker-base's size): 12
# layers of 768, 12 heads of 64, FFN 3072, positions numbered from 2 in a
# 514-row table, one token-type row, eps 1e-5, mean pooling + L2
MULTILINGUAL_E5_BASE = BertConfig(
    n_vocab=250002, n_ctx=512, n_embd=768, n_layer=12, n_head=12, n_ff=3072,
    layer_norm_eps=1e-5, n_token_types=1, arch="roberta", pos_offset=2,
    name="multilingual-e5-base",
)
# sentence-transformers/multi-qa-distilbert-cos-v1 geometry (DistilBertModel):
# 6 layers of 768, 12 heads, FFN 3072, no token-type table, mean pooling + L2
MULTI_QA_DISTILBERT = BertConfig(
    n_vocab=30522, n_ctx=512, n_embd=768, n_layer=6, n_head=12, n_ff=3072,
    n_token_types=0, arch="distilbert", name="multi-qa-distilbert-cos-v1",
)
# cross-encoder/ms-marco-electra-base geometry (ElectraForSequenceClassification):
# 12 layers of 768, 12 heads, FFN 3072, embedding_size 768 (no projection),
# one logit through dense + gelu + out_proj on the first token
MS_MARCO_ELECTRA_BASE = BertConfig(
    n_vocab=30522, n_ctx=512, n_embd=768, n_layer=12, n_head=12, n_ff=3072,
    arch="electra", n_labels=1, head_activation="gelu",
    name="ms-marco-electra-base",
)
# google/electra-small-discriminator geometry: 12 layers of 256, 4 heads of
# 64, FFN 1024, 128-wide embedding tables projected up to 256
ELECTRA_SMALL = BertConfig(
    n_vocab=30522, n_ctx=512, n_embd=256, n_layer=12, n_head=4, n_ff=1024,
    arch="electra", n_embd_emb=128, name="electra-small-discriminator",
)
# sentence-transformers/all-mpnet-base-v2 geometry (MPNetModel): 12 layers
# of 768, 12 heads of 64, FFN 3072, positions from 2, no token types, eps
# 1e-5, one 32-bucket relative bias table shared by every layer
MPNET_BASE = BertConfig(
    n_vocab=30527, n_ctx=512, n_embd=768, n_layer=12, n_head=12, n_ff=3072,
    n_token_types=0, arch="mpnet", pos_offset=2, rel_attn_buckets=32,
    layer_norm_eps=1e-5,
    name="all-mpnet-base-v2",
)
# sentence-transformers/gtr-t5-base geometry (the t5-base encoder, mean
# pooled; the synthetic preset skips the Dense head): 12 pre-norm RMSNorm
# blocks of 768, 12 heads of d_kv 64, relu FFN 3072, unscaled attention
# with a 32-bucket relative bias shared by every layer
GTR_BASE = BertConfig(
    n_vocab=32128, n_ctx=512, n_embd=768, n_layer=12, n_head=12, n_ff=3072,
    n_token_types=0, arch="t5", layer_norm_eps=1e-6, rel_attn_buckets=32,
    n_head_dim=64, ffn_act="relu",
    name="gtr-t5-base",
)
# albert-base-v2 geometry (AlbertModel): 128-wide embedding tables projected
# to 768, one shared layer applied 12 times (12 heads of 64, FFN 3072,
# gelu_new), two token types
ALBERT_BASE = BertConfig(
    n_vocab=30000, n_ctx=512, n_embd=768, n_layer=12, n_head=12, n_ff=3072,
    arch="albert", gelu="tanh", n_embd_emb=128, name="albert-base-v2",
)

"""MTEB-protocol task implementations (self-contained; no `mteb` package).

The port's copy of the JAX package's `benchmarks/tasks.py`: the same
datasets for the same seeds, the same metrics.  The two tasks the
reference evaluates (its benchmarks/run_mteb.py:23-28):

- **STSBenchmark**: embed sentence pairs, score = Spearman correlation of
  cosine similarity vs human gold scores (MTEB's `cos_sim.spearman`).
- **EmotionClassification**: embed train/test texts, fit logistic
  regression (100 L-BFGS iterations like MTEB's linear classifier), score =
  test accuracy.  The classifier is this module's own
  (`LogisticRegression`): scikit-learn's objective and solver settings on
  numpy and scipy, so the harness needs no scikit-learn.

Plus **SyntheticRetrieval** (`synthetic_retrieval`, `eval_retrieval`):
graded nDCG@10 / recall@10 over a cluster-structured corpus.

Dataset sources (zero-egress friendly, tried in order):
1. a local JSON file (see `load_sts_local`),
2. the HF `datasets` cache (works offline once populated),
3. `synthetic_sts` / `synthetic_classification` generators, which build a
   corpus with controlled lexical overlap so the full pipeline (tokenize ->
   embed -> correlate) can be exercised and regression-tested hermetically.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class STSData:
    sentences1: list[str]
    sentences2: list[str]
    scores: list[float]  # gold similarity, any monotonic scale


@dataclass
class ClassificationData:
    train_texts: list[str]
    train_labels: list[int]
    test_texts: list[str]
    test_labels: list[int]


@dataclass
class RetrievalData:
    corpus: list[str]
    queries: list[str]
    qrels: list[dict[int, float]]  # per query: corpus idx -> graded gain


# --- dataset loading --------------------------------------------------------

def load_sts_local(path: str | Path) -> STSData:
    """JSON: [{"sentence1": ..., "sentence2": ..., "score": ...}, ...]"""
    rows = json.loads(Path(path).read_text())
    return STSData(
        [r["sentence1"] for r in rows],
        [r["sentence2"] for r in rows],
        [float(r["score"]) for r in rows],
    )


def load_stsbenchmark_hf(split: str = "test") -> STSData:
    """mteb/stsbenchmark-sts via the HF datasets cache (offline-capable)."""
    import datasets

    ds = datasets.load_dataset("mteb/stsbenchmark-sts", split=split)
    return STSData(ds["sentence1"], ds["sentence2"], [float(s) for s in ds["score"]])


def load_emotion_hf() -> ClassificationData:
    import datasets

    train = datasets.load_dataset("mteb/emotion", split="train")
    test = datasets.load_dataset("mteb/emotion", split="test")
    return ClassificationData(
        train["text"], train["label"], test["text"], test["label"]
    )


_WORDS = (
    "market stock fell sharply news report today weather rain sun cloud "
    "team game win loss player music guitar stage concert crowd food "
    "dinner cook family recipe train city travel station street dog cat "
    "animal park garden tree child school study book exam computer "
    "program error code test water river mountain trail snow fire house "
    "door window room table"
).split()


def synthetic_sts(n: int = 512, seed: int = 0) -> STSData:
    """Pairs whose gold score is their constructed lexical overlap — any
    reasonable embedding model should correlate positively."""
    rng = np.random.default_rng(seed)
    s1, s2, gold = [], [], []
    for _ in range(n):
        length = int(rng.integers(6, 14))
        base = list(rng.choice(_WORDS, size=length))
        overlap = float(rng.uniform(0, 1))
        keep = int(round(overlap * length))
        other = list(base[:keep]) + list(rng.choice(_WORDS, size=length - keep))
        rng.shuffle(other)
        s1.append(" ".join(base))
        s2.append(" ".join(other))
        gold.append(overlap)
    return STSData(s1, s2, gold)


def synthetic_classification(
    n_train: int = 256, n_test: int = 128, n_classes: int = 4, seed: int = 0
) -> ClassificationData:
    """Each class has a distinct vocabulary subset; embeddings must separate
    them linearly."""
    rng = np.random.default_rng(seed)
    per_class = [
        list(rng.choice(_WORDS, size=12, replace=False)) for _ in range(n_classes)
    ]

    def make(n):
        texts, labels = [], []
        for _ in range(n):
            c = int(rng.integers(n_classes))
            words = list(rng.choice(per_class[c], size=8)) + list(
                rng.choice(_WORDS, size=3)
            )
            rng.shuffle(words)
            texts.append(" ".join(words))
            labels.append(c)
        return texts, labels

    tr = make(n_train)
    te = make(n_test)
    return ClassificationData(tr[0], tr[1], te[0], te[1])


def synthetic_retrieval(
    n_queries: int = 24, n_topics: int = 8, distractors: int = 120,
    seed: int = 0,
) -> RetrievalData:
    """Cluster-structured corpus with KNOWN graded relevance.

    The topics partition _WORDS into DISJOINT vocabularies.  Per query: one
    near-duplicate document (the query's own words — gain 3); every other
    document of the query's topic is topically relevant (gain 1);
    distractors draw from OTHER topics only (gain 0, zero lexical overlap
    with the query).  Lexical overlap therefore IS the ground truth, so any
    reasonable text encoder — random-weight synthetic models included,
    whose shared token embeddings still make overlapping texts similar —
    separates relevant from not; a broken ranking path (RRF fusion, COO
    padding, top-k selection) collapses the scores toward chance."""
    rng = np.random.default_rng(seed)
    width = len(_WORDS) // n_topics
    per_topic = [
        list(_WORDS[t * width:(t + 1) * width]) for t in range(n_topics)
    ]
    corpus: list[str] = []
    queries: list[str] = []
    topic_docs: dict[int, list[int]] = {t: [] for t in range(n_topics)}
    near_of: list[int] = []
    for qi in range(n_queries):
        t = qi % n_topics
        qwords = list(rng.choice(per_topic[t], size=8))
        queries.append(" ".join(qwords))
        near = qwords[:6] + list(rng.choice(per_topic[t], size=2))
        rng.shuffle(near)
        near_of.append(len(corpus))
        topic_docs[t].append(len(corpus))
        corpus.append(" ".join(near))
        for _ in range(2):
            same = list(rng.choice(per_topic[t], size=9))
            rng.shuffle(same)
            topic_docs[t].append(len(corpus))
            corpus.append(" ".join(same))
    for _ in range(distractors):
        t = int(rng.integers(n_topics))
        words = list(rng.choice(per_topic[t], size=9))
        rng.shuffle(words)
        topic_docs[t].append(len(corpus))
        corpus.append(" ".join(words))
    qrels = []
    for qi in range(n_queries):
        t = qi % n_topics
        rel = {d: 1.0 for d in topic_docs[t]}
        rel[near_of[qi]] = 3.0
        qrels.append(rel)
    return RetrievalData(corpus, queries, qrels)


# --- metrics ------------------------------------------------------------------

def ndcg_at_k(ranked_ids: np.ndarray, qrels: dict[int, float],
              k: int) -> float:
    """Standard graded nDCG@k: DCG = sum gain / log2(rank + 1) over the
    top-k ranking (rank 1-based), normalized by the ideal DCG of the gold
    gains.  -1 ids (padding) contribute 0."""
    gains = [qrels.get(int(d), 0.0) for d in ranked_ids[:k]]
    dcg = sum(g / np.log2(r + 2) for r, g in enumerate(gains))
    ideal = sorted(qrels.values(), reverse=True)[:k]
    idcg = sum(g / np.log2(r + 2) for r, g in enumerate(ideal))
    return float(dcg / idcg) if idcg > 0 else 0.0


def recall_at_k(ranked_ids: np.ndarray, qrels: dict[int, float],
                k: int) -> float:
    relevant = {d for d, g in qrels.items() if g > 0}
    if not relevant:
        return 0.0
    got = {int(d) for d in ranked_ids[:k]} & relevant
    return len(got) / len(relevant)


def eval_retrieval(search_fn, data: RetrievalData, k: int = 10,
                   name: str = "SyntheticRetrieval") -> dict:
    """search_fn: (queries, k) -> (ids [Q, k], scores).  Returns an
    MTEB-retrieval-style dict (ndcg_at_10 as main_score, like MTEB's
    retrieval tasks report)."""
    t0 = time.perf_counter()
    ids, _ = search_fn(data.queries, k)
    eval_time = time.perf_counter() - t0
    ndcg = float(np.mean([
        ndcg_at_k(ids[i], data.qrels[i], k) for i in range(len(data.queries))
    ]))
    rec = float(np.mean([
        recall_at_k(ids[i], data.qrels[i], k)
        for i in range(len(data.queries))
    ]))
    return {
        "mteb_dataset_name": name,
        "test": {
            f"ndcg_at_{k}": round(ndcg, 5),
            f"recall_at_{k}": round(rec, 5),
            "main_score": round(ndcg, 5),
            "evaluation_time": round(eval_time, 2),
        },
    }


# --- the classifier -------------------------------------------------------------

class LogisticRegression:
    """scikit-learn's `LogisticRegression()` fit, on numpy and scipy: L2
    with strength `C`, an unpenalized intercept, the multinomial loss over
    three or more classes (the binomial one over two), minimized from zero
    by L-BFGS-B with scikit-learn's settings (`max_iter` iterations, 50
    line-search steps, gtol `tol`, ftol 64 eps).  The objective is
    scikit-learn's: the mean log loss + 1 / (2 C n) |W|^2, in f64."""

    def __init__(self, C: float = 1.0, max_iter: int = 100, tol: float = 1e-4):
        self.C, self.max_iter, self.tol = float(C), int(max_iter), float(tol)

    def fit(self, x, y) -> "LogisticRegression":
        from scipy.optimize import minimize
        from scipy.special import log_softmax, softmax

        x = np.asarray(x, np.float64)
        self.classes_, yi = np.unique(np.asarray(y), return_inverse=True)
        n, f = x.shape
        binary = len(self.classes_) == 2
        nc = 1 if binary else len(self.classes_)
        l2 = 1.0 / (self.C * n)
        onehot = np.eye(len(self.classes_))[yi]

        def loss_grad(w):
            w = w.reshape(nc, f + 1)
            raw = x @ w[:, :f].T + w[:, f]
            if binary:
                z = raw[:, 0]
                # log(1 + exp(z)) - y z, and its gradient sigmoid(z) - y
                loss = np.mean(np.logaddexp(0.0, z) - yi * z)
                err = (0.5 * (1.0 + np.tanh(0.5 * z)) - yi)[:, None]
            else:
                loss = -np.mean(np.sum(onehot * log_softmax(raw, axis=1), axis=1))
                err = softmax(raw, axis=1) - onehot
            coef = w[:, :f]
            grad = np.concatenate([err.T @ x / n + l2 * coef, err.sum(0)[:, None] / n], 1)
            return loss + 0.5 * l2 * float(np.sum(coef * coef)), grad.ravel()

        res = minimize(loss_grad, np.zeros(nc * (f + 1)), method="L-BFGS-B", jac=True,
                       options={"maxiter": self.max_iter, "maxls": 50, "gtol": self.tol,
                                "ftol": 64 * np.finfo(float).eps})
        w = res.x.reshape(nc, f + 1)
        self.coef_, self.intercept_, self.n_iter_ = w[:, :f], w[:, f], int(res.nit)
        return self

    def decision_function(self, x) -> np.ndarray:
        raw = np.asarray(x, np.float64) @ self.coef_.T + self.intercept_
        return raw[:, 0] if len(self.classes_) == 2 else raw

    def predict(self, x) -> np.ndarray:
        d = self.decision_function(x)
        return self.classes_[(d > 0).astype(int) if d.ndim == 1 else d.argmax(1)]

    def score(self, x, y) -> float:
        return float(np.mean(self.predict(x) == np.asarray(y)))


# --- evaluation -------------------------------------------------------------

def eval_sts(encode_fn, data: STSData) -> dict:
    """encode_fn: list[str] -> np.ndarray [n, d].  Returns MTEB-style dict."""
    from scipy.stats import pearsonr, spearmanr

    t0 = time.perf_counter()
    emb1 = np.asarray(encode_fn(data.sentences1), dtype=np.float32)
    emb2 = np.asarray(encode_fn(data.sentences2), dtype=np.float32)
    eval_time = time.perf_counter() - t0

    def norm(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

    cos = np.sum(norm(emb1) * norm(emb2), axis=-1)
    spear = float(spearmanr(data.scores, cos).statistic)
    pear = float(pearsonr(data.scores, cos).statistic)
    return {
        "mteb_dataset_name": "STSBenchmark",
        "test": {
            "cos_sim": {"spearman": spear, "pearson": pear},
            "evaluation_time": round(eval_time, 2),
        },
    }


def eval_classification(encode_fn, data: ClassificationData) -> dict:
    t0 = time.perf_counter()
    x_train = np.asarray(encode_fn(data.train_texts), dtype=np.float32)
    x_test = np.asarray(encode_fn(data.test_texts), dtype=np.float32)
    eval_time = time.perf_counter() - t0

    clf = LogisticRegression(max_iter=100)
    clf.fit(x_train, data.train_labels)
    acc = float(clf.score(x_test, data.test_labels))
    return {
        "mteb_dataset_name": "EmotionClassification",
        "test": {
            "accuracy": acc,
            "main_score": acc,
            "evaluation_time": round(eval_time, 2),
        },
    }

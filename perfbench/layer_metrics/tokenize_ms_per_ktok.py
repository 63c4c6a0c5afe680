"""Host milliseconds the tokenizer (`Engine.tokenize_batch`, the native
engines of `tokenizer/native.py`) took per 1000 tokens it returned, from
the benchmark's span around it over the window."""


def read(run):
    seconds, tokens = run.tokenize_delta()
    return seconds * 1e3 / (tokens / 1e3) if tokens else None

"""Command-line tools: convert, quantize, make_test_model."""

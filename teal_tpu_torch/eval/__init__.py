"""Evaluation: sliding-window perplexity (`ppl.eval_ppl`), the TEAL
accuracy gate."""

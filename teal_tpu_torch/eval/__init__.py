"""Evaluation: sliding-window perplexity (`ppl.eval_ppl`), the TEAL
accuracy gate, and the lm-eval adapter (`harness.ScoreModel`,
`harness.make_lm_eval_model`) with its shim (`lm_eval_shim`)."""

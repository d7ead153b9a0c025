"""Minimal lm-evaluation-harness API shim.

Port of `teal_tpu/eval/lm_eval_shim.py`, pure Python and unchanged: the
`LM` base class with the three request types of `lm_eval.api.model.LM`
(loglikelihood, loglikelihood_rolling, generate_until) plus a small
evaluator for multiple-choice and greedy-generation tasks in the
harness's request shapes (requests carry `.args` tuples, the 0.4 API's
calling convention). `teal_tpu_torch.eval.harness.make_lm_eval_model`
takes the real `lm_eval` when it is installed and this shim otherwise,
with the same adapter code either way.

Reference parity: `gpt-fast/eval.py:85-196` wires lm_eval's HFLM and its
evaluator; this shim substitutes only the harness plumbing, not the
model adapter.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass
class Instance:
    """A single request, mirroring lm_eval.api.instance.Instance."""

    request_type: str
    args: Tuple
    idx: int = 0
    metadata: dict = field(default_factory=dict)


class LM:
    """Base class mirroring lm_eval.api.model.LM's abstract interface."""

    def loglikelihood(self, requests: List[Instance]) -> List[Tuple[float, bool]]:
        raise NotImplementedError

    def loglikelihood_rolling(self, requests: List[Instance]) -> List[float]:
        raise NotImplementedError

    def generate_until(self, requests: List[Instance]) -> List[str]:
        raise NotImplementedError


@dataclass
class MultipleChoiceTask:
    """hellaswag-shaped task: pick the highest-loglikelihood continuation.

    docs: [{"query": str, "choices": [str, ...], "gold": int}, ...]
    """

    name: str
    docs: List[Dict]

    def evaluate(self, lm: LM) -> Dict[str, float]:
        requests = []
        for di, doc in enumerate(self.docs):
            for ci, choice in enumerate(doc["choices"]):
                requests.append(Instance(
                    request_type="loglikelihood",
                    args=(doc["query"], choice),
                    idx=len(requests),
                    metadata={"doc": di, "choice": ci},
                ))
        results = lm.loglikelihood(requests)
        # group results per doc in one pass (rescanning the request list
        # per doc is O(docs x requests) — minutes of pure Python on a
        # hellaswag-sized task after inference already finished)
        by_doc: Dict[int, list] = {}
        for req, (lp, _greedy) in zip(requests, results):
            cont = self.docs[req.metadata["doc"]]["choices"][
                req.metadata["choice"]]
            by_doc.setdefault(req.metadata["doc"], []).append(
                # byte length, matching the harness's acc_norm definition
                (req.metadata["choice"], lp, len(cont.encode("utf-8"))))
        n_correct = 0
        n_correct_norm = 0
        for di, doc in enumerate(self.docs):
            scores = by_doc[di]
            best = max(scores, key=lambda s: s[1])[0]
            # byte-length-normalized variant (acc_norm in the harness)
            best_norm = max(scores, key=lambda s: s[1] / max(s[2], 1))[0]
            n_correct += best == doc["gold"]
            n_correct_norm += best_norm == doc["gold"]
        n = max(len(self.docs), 1)
        return {"acc": n_correct / n, "acc_norm": n_correct_norm / n}


@dataclass
class GenerateTask:
    """Greedy-generation task: exact-match against a target string.

    docs: [{"query": str, "target": str}, ...]
    """

    name: str
    docs: List[Dict]
    until: Sequence[str] = ("\n",)
    max_gen_toks: int = 32

    def evaluate(self, lm: LM) -> Dict[str, float]:
        requests = [
            Instance(
                request_type="generate_until",
                args=(doc["query"],
                      {"until": list(self.until),
                       "max_gen_toks": self.max_gen_toks}),
                idx=i,
            )
            for i, doc in enumerate(self.docs)
        ]
        outs = lm.generate_until(requests)
        n = max(len(self.docs), 1)
        exact = sum(
            out.strip() == doc["target"].strip()
            for out, doc in zip(outs, self.docs)
        )
        return {"exact_match": exact / n}


def simple_evaluate(lm: LM, tasks) -> Dict[str, Dict[str, float]]:
    """Run tasks against a model; returns {task_name: {metric: value}}
    (the shape of lm_eval.simple_evaluate()['results'])."""
    return {t.name: t.evaluate(lm) for t in tasks}

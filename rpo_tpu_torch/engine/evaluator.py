"""Classification evaluator with the Dassl log-format contract.

A copy of ``rpo_tpu/engine/evaluator.py`` (numpy only).  The printed
block is a public API: ``parse_test_res.py`` regex-scrapes
``* accuracy: X%`` lines after an ``=> result`` marker.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class ClassificationEvaluator:
    def __init__(self, cfg, classnames: Optional[List[str]] = None):
        self.cfg = cfg
        self.classnames = classnames
        self.per_class = bool(cfg.TEST.PER_CLASS_RESULT) if cfg is not None else False
        # Dassl's COMPUTE_CMAT saves a confusion matrix to the output dir
        self.compute_cmat = bool(cfg.TEST.COMPUTE_CMAT) if cfg is not None else False
        self.output_dir = str(cfg.OUTPUT_DIR) if cfg is not None else ""
        self.reset()

    def reset(self) -> None:
        self._correct = 0
        self._total = 0
        self._y_true: List[int] = []
        self._y_pred: List[int] = []

    def process(self, logits: np.ndarray, labels: np.ndarray) -> None:
        """logits: (B, n_cls); labels: (B,) int.

        Hot path: the pipelined test() loop calls this per batch while
        draining device transfers — only O(1) bookkeeping here; per-class
        tallies are derived from the stored labels at evaluate() time."""
        pred = np.asarray(logits).argmax(axis=-1)
        labels = np.asarray(labels)
        self._correct += int((pred == labels).sum())
        self._total += int(labels.shape[0])
        self._y_true.extend(labels.tolist())
        self._y_pred.extend(pred.tolist())

    def _macro_f1(self) -> float:
        y_true = np.asarray(self._y_true)
        y_pred = np.asarray(self._y_pred)
        # Dassl averages over labels=np.unique(y_true) ONLY: a class that
        # is predicted but absent from the ground truth contributes no
        # zero term (sklearn f1_score semantics with an explicit labels=)
        classes = np.unique(y_true)
        f1s = []
        for c in classes:
            tp = int(((y_pred == c) & (y_true == c)).sum())
            fp = int(((y_pred == c) & (y_true != c)).sum())
            fn = int(((y_pred != c) & (y_true == c)).sum())
            denom = 2 * tp + fp + fn
            f1s.append(2 * tp / denom if denom else 0.0)
        return 100.0 * float(np.mean(f1s)) if f1s else 0.0

    def evaluate(self) -> Dict[str, float]:
        acc = 100.0 * self._correct / max(1, self._total)
        err = 100.0 - acc
        macro_f1 = self._macro_f1()
        results = {
            "accuracy": acc,
            "error_rate": err,
            "macro_f1": macro_f1,
            "total": self._total,
            "correct": self._correct,
        }
        print("=> result")
        print(f"* total: {self._total:,}")
        print(f"* correct: {self._correct:,}")
        print(f"* accuracy: {acc:.1f}%")
        print(f"* error: {err:.1f}%")
        print(f"* macro_f1: {macro_f1:.1f}%")
        if self.per_class and self._y_true:
            y_true = np.asarray(self._y_true)
            y_pred = np.asarray(self._y_pred)
            print("=> per-class result")
            accs = []
            for lab in np.unique(y_true).tolist():
                sel = y_true == lab
                total = int(sel.sum())
                correct = int((y_pred[sel] == lab).sum())
                pc_acc = 100.0 * correct / max(1, total)
                accs.append(pc_acc)
                name = (
                    self.classnames[lab]
                    if self.classnames is not None and lab < len(self.classnames)
                    else str(lab)
                )
                print(
                    f"* class: {lab} ({name})\t"
                    f"total: {total:,}\t"
                    f"correct: {correct:,}\t"
                    f"acc: {pc_acc:.1f}%"
                )
            mean_acc = float(np.mean(accs)) if accs else 0.0
            print(f"* average: {mean_acc:.1f}%")
            # Dassl stores the per-class mean under this key
            results["perclass_accuracy"] = mean_acc
        if self.compute_cmat and self._y_true:
            import os

            y_true = np.asarray(self._y_true)
            y_pred = np.asarray(self._y_pred)
            # Dassl saves sklearn confusion_matrix(y_true, y_pred,
            # normalize="true") to <output>/cmat.pt: rows indexed by the
            # sorted union of observed labels, each row normalized by its
            # ground-truth count (rows for predicted-only labels are NaN,
            # matching sklearn's 0/0).
            labels = np.unique(np.concatenate([y_true, y_pred]))
            pos = {int(lab): i for i, lab in enumerate(labels)}
            n = len(labels)
            cmat = np.zeros((n, n), dtype=np.float64)
            np.add.at(
                cmat,
                ([pos[int(t)] for t in y_true], [pos[int(p)] for p in y_pred]),
                1.0,
            )
            with np.errstate(invalid="ignore"):
                cmat = cmat / cmat.sum(axis=1, keepdims=True)
            os.makedirs(self.output_dir or ".", exist_ok=True)
            path = os.path.join(self.output_dir or ".", "cmat.pt")
            import torch

            torch.save(torch.from_numpy(cmat), path)
            print(f"Confusion matrix is saved to {path}")
        return results

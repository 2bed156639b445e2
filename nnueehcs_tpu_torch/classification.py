"""ID/OOD percentile-threshold classifiers.

Counterpart of ``nnueehcs_tpu/classification.py``. Scores arrive as torch
tensors (on any device) or arrays; the threshold is the given quantile of
the ID scores, and the counts above and below it on each side give
sensitivity, specificity, fpr and fnr with guarded denominators, including
the reference's all-identical-ID-scores edge case.
"""
from __future__ import annotations

import numpy as np
import torch


def _flat(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).reshape(-1)


class _IdOodClassifier:
    def evaluate(self, model, id_data: tuple, ood_data: tuple) -> dict:
        id_ipt, id_opt = id_data
        ood_ipt, ood_opt = ood_data
        model.eval()
        id_preds, id_scores = model(id_ipt, return_ue=True)
        ood_preds, ood_scores = model(ood_ipt, return_ue=True)

        metrics = self._evaluate_scores(id_scores, ood_scores)
        metrics.update({
            'id_preds': id_preds,
            'ood_preds': ood_preds,
            'id_scores': id_scores,
            'ood_scores': ood_scores,
        })
        return metrics


class PercentileBasedIdOodClassifier(_IdOodClassifier):
    def __init__(self, percentile: float):
        if not 0 <= percentile <= 1:
            raise ValueError(f'Percentile must be between 0 and 1, got {percentile}')
        self.percentile = percentile

    @staticmethod
    def _ratio(num, denom_a, denom_b):
        denom = denom_a + denom_b
        if denom == 0:
            return 0.0
        return float(num) / denom

    def _fpr(self, false_positives, true_negatives):
        return self._ratio(false_positives, false_positives, true_negatives)

    def _fnr(self, false_negatives, true_positives):
        return self._ratio(false_negatives, false_negatives, true_positives)

    def _sensitivity(self, true_positives, false_negatives):
        return self._ratio(true_positives, true_positives, false_negatives)

    def _specificity(self, true_negatives, false_positives):
        return self._ratio(true_negatives, true_negatives, false_positives)

    def _evaluate_scores(self, id_scores, ood_scores) -> dict:
        id_scores = _flat(id_scores)
        ood_scores = _flat(ood_scores)

        if np.all(id_scores == id_scores[0]):
            threshold = id_scores[0]
        else:
            threshold = np.quantile(id_scores, self.percentile)

        id_above = int((id_scores > threshold).sum())
        id_below = int((id_scores <= threshold).sum())
        ood_above = int((ood_scores > threshold).sum())
        ood_below = int((ood_scores <= threshold).sum())

        return {
            'sensitivity': float(self._sensitivity(ood_above, ood_below)),
            'specificity': float(self._specificity(id_below, id_above)),
            'fpr': float(self._fpr(id_above, id_below)),
            'fnr': float(self._fnr(ood_below, ood_above)),
        }

    @classmethod
    def get_objectives(cls):
        return [{'name': 'sensitivity', 'type': 'maximize'}]

    @classmethod
    def get_metrics(cls):
        return ['sensitivity']


class ReversedPercentileBasedIdOodClassifier(PercentileBasedIdOodClassifier):
    """Lower scores indicate OOD."""

    def _evaluate_scores(self, id_scores, ood_scores) -> dict:
        id_scores = _flat(id_scores)
        ood_scores = _flat(ood_scores)

        threshold = np.quantile(id_scores, 1 - self.percentile)

        false_positives = int((id_scores <= threshold).sum())
        true_negatives = int((id_scores > threshold).sum())
        false_negatives = int((ood_scores > threshold).sum())
        true_positives = int((ood_scores <= threshold).sum())

        return {
            'sensitivity': float(self._sensitivity(true_positives, false_negatives)),
            'specificity': float(self._specificity(true_negatives, false_positives)),
            'fpr': float(self._fpr(false_positives, true_negatives)),
            'fnr': float(self._fnr(false_negatives, true_positives)),
        }

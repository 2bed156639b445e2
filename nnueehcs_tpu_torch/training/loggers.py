"""CSV metrics logger with the Lightning CSVLogger directory and file
contract.

Counterpart of ``nnueehcs_tpu/training/loggers.py``: rows go to
``<save_dir>/<name>/<version>/metrics.csv`` with interleaved
``train_loss``/``val_loss`` rows and ``epoch``/``step`` columns, appended
epoch by epoch (the file is rewritten only when the column set changes),
and the hyperparameters to ``hparams.yaml`` beside it. The machine with
the card has no ``yaml`` package, so :func:`dump_yaml` writes the file
itself: ``yaml.safe_load`` reads it back as the dict the JAX logger
writes with ``yaml.safe_dump``.
"""
from __future__ import annotations

import csv
import json
import math
import os
from typing import Optional


class CSVLogger:
    def __init__(self, save_dir: str, name: str = 'default',
                 version: Optional[str] = None):
        self.save_dir = save_dir
        self.name = name
        if version is None:
            version = self._next_version(os.path.join(save_dir, name))
        self.version = version
        self._rows = []
        self._keys = []
        self._hparams = {}
        self._flushed = 0
        self._flushed_keys = None

    @staticmethod
    def _next_version(root: str) -> str:
        existing = []
        if os.path.isdir(root):
            for item in os.listdir(root):
                if item.startswith('version_'):
                    try:
                        existing.append(int(item.split('_')[1]))
                    except (IndexError, ValueError):
                        pass
        return f'version_{max(existing) + 1 if existing else 0}'

    @property
    def log_dir(self) -> str:
        version = self.version
        if isinstance(version, int):
            version = f'version_{version}'
        return os.path.join(self.save_dir, self.name, str(version))

    def log_hyperparams(self, params: dict):
        self._hparams.update(params)
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, 'hparams.yaml'), 'w') as f:
            f.write(dump_yaml(self._hparams))

    def log_metrics(self, metrics: dict, step: Optional[int] = None):
        row = dict(metrics)
        if step is not None:
            row['step'] = step
        for k in row:
            if k not in self._keys:
                self._keys.append(k)
        self._rows.append(row)

    def save(self):
        if not self._rows:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, 'metrics.csv')
        fresh = self._flushed_keys != self._keys or not os.path.exists(path)
        start = 0 if fresh else self._flushed
        if start >= len(self._rows) and not fresh:
            return
        with open(path, 'w' if fresh else 'a', newline='') as f:
            writer = csv.DictWriter(f, fieldnames=self._keys)
            if fresh:
                writer.writeheader()
            for row in self._rows[start:]:
                writer.writerow(row)
        self._flushed = len(self._rows)
        self._flushed_keys = list(self._keys)

    def finalize(self):
        self.save()


def _yaml_scalar(v) -> str:
    if v is None:
        return 'null'
    if isinstance(v, bool):
        return 'true' if v else 'false'
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return '.nan'
        if math.isinf(v):
            return '.inf' if v > 0 else '-.inf'
        text = repr(v)
        # YAML 1.1 reads an exponent without a dot as a string
        if '.' not in text and 'e' in text:
            text = text.replace('e', '.0e')
        return text
    return json.dumps(str(v))          # a double-quoted YAML scalar


def _yaml_flow(obj) -> str:
    """``obj`` as a YAML flow node: dicts and lists nest, strings are
    double-quoted, any other object becomes its ``repr`` (as the JAX
    logger's ``_yaml_safe`` does)."""
    if isinstance(obj, dict):
        return '{' + ', '.join(f'{json.dumps(str(k))}: {_yaml_flow(v)}'
                               for k, v in obj.items()) + '}'
    if isinstance(obj, (list, tuple)):
        return '[' + ', '.join(_yaml_flow(v) for v in obj) + ']'
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return _yaml_scalar(obj)
    return _yaml_scalar(repr(obj))


def dump_yaml(params: dict) -> str:
    """A YAML document of ``params``: one block-mapping line per key, each
    value a flow node."""
    return ''.join(f'{json.dumps(str(k))}: {_yaml_flow(v)}\n'
                   for k, v in sorted(params.items(), key=lambda kv: str(kv[0])))

#!/usr/bin/env python3
"""Time the whole fit with its validation batches spread over 2, 4 or 8
CUDA streams against one batch after another, in fp32 and bf16-mixed, on
one card:

    python3 tools/validation_streams.py [--seed N] [--rounds R]

The fit is the flagship trial of ``chip_smoke.py``'s ``whole_fit`` phase
(``chip_smoke.whole_fit_run``: 8 members, 7 Linear layers 128 wide,
batch 128, 1,000 steps an epoch, 100 validation batches of 128 rows,
EarlyStopping and a deferred ModelSavingCallback) with ``whole_fit:
true`` and ``trainer.VALIDATION_STREAMS`` set to each count for both
dtypes (0: one batch after another), and the per-epoch path (``whole_fit: false``) beside it.
Seconds an epoch are a 6-epoch fit less a 2-epoch one, over 4, so a
fit's fixed costs cancel; the counts run in turns (0, 2, 4, 8, the
per-epoch path, then the reverse order) for ``--rounds`` rounds after
one warm-up fit each. For each count it also times one validation pass
of a fresh flagship model as the dispatch enqueues it (the float64 mean
on the card, which must be the serial mean bit for bit): CUDA-event
time, and the host's seconds to enqueue it. Rows are standard normal
from ``--seed``, the target ``chip_smoke.smooth_target`` of them
(learnable, so no fit stops early; each must train all its epochs).
Prints one JSON line a reading, then the card's ``nvidia-smi`` name and
power limit. It needs a CUDA card.
"""
import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS = (0, 2, 4, 8)
EPOCHS_LONG, EPOCHS_SHORT = 6, 2


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--rounds', type=int, default=2)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('validation_streams: no CUDA card', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from nnueehcs_tpu_torch.attrib import event_ms, nvidia_smi
    from nnueehcs_tpu_torch.model_builder import EnsembleModelBuilder
    from nnueehcs_tpu_torch.training import trainer as trainer_mod
    from nnueehcs_tpu_torch.training.whole_fit import weighted_mean

    rng = np.random.default_rng(args.seed)
    rows = cs.TRAIN_SPLIT + cs.TRAIN_CONFIG['limit_val_batches'] \
        * cs.TRAIN_BATCH
    x = rng.standard_normal((rows, cs.IN_DIM)).astype(np.float32)
    y = cs.smooth_target(x)

    def model():
        return EnsembleModelBuilder(
            cs.FLAGSHIP, {'num_models': cs.MEMBERS},
            train_config=dict(cs.TRAIN_MODEL_CONFIG), seed=args.seed,
            device=cs.DEVICE).build()

    def fit(count, precision, epochs):
        """(seconds, trainer) of one fit; ``count`` None: per epoch."""
        trainer_mod.VALIDATION_STREAMS = dict.fromkeys(
            (None, torch.bfloat16), count or 0)
        trainer, _, _, seconds, _ = cs.whole_fit_run(
            f'streams_{count}_{precision}', model(), x, y, epochs,
            args.seed, count is not None, precision=precision)
        if trainer.fused_epochs_used != epochs:
            raise RuntimeError(f'{count} streams, {precision}: '
                               f'{trainer.fused_epochs_used} of {epochs} '
                               'epochs trained')
        return seconds, trainer

    def pass_times(count, precision):
        """One validation pass on ``count`` streams: CUDA-event ms and
        the host's ms to enqueue it."""
        m = model()
        m.set_precision(precision)
        x_val = torch.as_tensor(x[cs.TRAIN_SPLIT:], device=cs.DEVICE)
        y_val = torch.as_tensor(y[cs.TRAIN_SPLIT:], device=cs.DEVICE)
        probe = trainer_mod.Trainer('probe', {}, log_dir=cs.WHOLE_FIT_DIR,
                                    device=cs.DEVICE)
        streams = [torch.cuda.Stream() for _ in range(count)]
        nb = cs.TRAIN_CONFIG['limit_val_batches']
        weights = probe._val_weights(x_val, cs.TRAIN_BATCH, nb)

        def one(spread=streams):
            return weighted_mean(probe._val_losses(
                m, x_val, y_val, cs.TRAIN_BATCH, nb, 0, spread), weights)
        if not torch.equal(one(), one(())):
            raise RuntimeError(f'{count} streams gave another mean')
        events = event_ms(one, warmup=2, trials=5)
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            start = time.perf_counter()
            one()
            host.append((time.perf_counter() - start) * 1e3)
        torch.cuda.synchronize()
        return events, statistics.median(host)

    labels = list(COUNTS) + [None]
    for precision in ('32-true', 'bf16-mixed'):
        for count in labels:
            fit(count, precision, EPOCHS_SHORT)
        seconds = {c: {EPOCHS_LONG: [], EPOCHS_SHORT: []} for c in labels}
        enqueue = {c: [] for c in COUNTS}
        for r in range(args.rounds):
            for count in (labels if r % 2 == 0 else labels[::-1]):
                for epochs in (EPOCHS_SHORT, EPOCHS_LONG):
                    t, trainer = fit(count, precision, epochs)
                    seconds[count][epochs].append(t)
                    if count is not None and epochs == EPOCHS_LONG:
                        enqueue[count].append(
                            trainer.whole_fit_seconds['enqueue'])
        for count in labels:
            per_epoch = [(a - b) / (EPOCHS_LONG - EPOCHS_SHORT)
                         for a, b in zip(seconds[count][EPOCHS_LONG],
                                         seconds[count][EPOCHS_SHORT])]
            line = {'precision': precision,
                    'streams': 'per_epoch_path' if count is None else count,
                    'seconds_per_epoch': per_epoch,
                    'seconds_per_epoch_median': statistics.median(per_epoch),
                    'fit_seconds': {str(e): v for e, v
                                    in seconds[count].items()}}
            if count is not None:
                events, host_ms = pass_times(count, precision)
                line.update(enqueue_seconds_6_epochs=enqueue[count],
                            validation_pass_event_ms=events,
                            validation_pass_host_ms=host_ms)
            print(json.dumps(line), flush=True)
    print(nvidia_smi('name,power.limit'), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

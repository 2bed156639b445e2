"""Single-run example: train a KDE-scored surrogate of the binomial-options
pricing kernel, evaluate the Wasserstein ID/OOD separation, and plot ECDFs
of the uncertainty scores (counterpart of
``examples/binomial_options/bo.py``).

Generate the dataset first, then run from ``examples/binomial_options``
(the config's dataset paths are relative)::

    python -m nnueehcs_tpu_torch.examples.data.generate_data \\
        --data-dir examples/data
    python -m nnueehcs_tpu_torch.examples.binomial_options.bo \\
        --config config.yaml [--eval_only] [--device cpu] [--no_plots]

It trains on the card unless ``--device cpu`` is given, writes the trainer's
logs under ``--log_dir`` (default ``logs``) and, unless ``--no_plots``,
``uncertainty.png``.
"""
from __future__ import annotations

import argparse
import glob

import numpy as np

from ... import config as config_reader
from ...data_utils import get_dataset_from_config
from ...evaluation import get_uncertainty_evaluator, to_numpy
from ...model_builder import KDEModelBuilder
from ...training import (DataLoader, EarlyStopping, ModelSavingCallback,
                         Trainer, load_model)
from ..bo_driven.plotting import pyplot

NAME = 'binomial_options'


def get_trainer(trainer_config, name, model, log_dir, device):
    callbacks = [EarlyStopping(monitor='val_loss', min_delta=0.00,
                               patience=300, verbose=False, mode='min'),
                 ModelSavingCallback(monitor='val_loss')]
    callbacks.extend(model.get_callbacks() or [])
    return Trainer(name, trainer_config, callbacks=callbacks,
                   log_dir=log_dir, device=device)


def train(config, log_dir, device):
    """Train the KDE model on ``bo_ds`` (min-max scaled by its own range);
    returns the run's log directory."""
    training_cfg = config['training']
    model_cfg = config['model']
    dset = get_dataset_from_config(config['datasets'], 'bo_ds')
    model = KDEModelBuilder(model_cfg['architecture'], model_cfg['kde'],
                            train_config=training_cfg, device=device).build()
    trainer = get_trainer(config['trainer'], NAME, model, log_dir, device)
    ipt = np.asarray(dset.input)
    opt = np.asarray(dset.output)
    dset.output = (opt - opt.min()) / (opt.max() - opt.min())
    dset.input = (ipt - ipt.min()) / (ipt.max() - ipt.min())
    train_dl = DataLoader(dset, batch_size=training_cfg['batch_size'],
                          shuffle=True)
    test_dl = DataLoader(dset, batch_size=training_cfg['batch_size'],
                         shuffle=False)
    trainer.fit(model, train_dl, test_dl)
    return trainer.logger.log_dir


def latest_log_dir(log_dir):
    """The newest ``<log_dir>/binomial_options/version_N``."""
    versions = sorted(glob.glob(f'{log_dir}/{NAME}/version_*'),
                      key=lambda p: int(p.rsplit('_', 1)[1]))
    if not versions:
        raise SystemExit(f'No trained model found under {log_dir}/{NAME}/')
    return versions[-1]


def evaluation_data(config):
    """20,000 rows each of ID (``bo_ds``) and OOD (``bo_ood``), OOD scaled
    by the ID range, then ID by its own."""
    dset_id = get_dataset_from_config(config['datasets'], 'bo_ds')
    dset_ood = get_dataset_from_config(config['datasets'], 'bo_ood')
    id_ipt = np.asarray(dset_id.input)
    id_opt = np.asarray(dset_id.output)
    ood_ipt = np.asarray(dset_ood.input)
    ood_opt = np.asarray(dset_ood.output)
    ood_ipt = (ood_ipt - id_ipt.min()) / (id_ipt.max() - id_ipt.min())
    ood_opt = (ood_opt - id_opt.min()) / (id_opt.max() - id_opt.min())
    id_ipt = (id_ipt - id_ipt.min()) / (id_ipt.max() - id_ipt.min())
    id_opt = (id_opt - id_opt.min()) / (id_opt.max() - id_opt.min())
    rng = np.random.default_rng(0)
    id_sel = rng.permutation(len(id_ipt))[:20000]
    ood_sel = rng.permutation(len(ood_ipt))[:20000]
    return ((id_ipt[id_sel], id_opt[id_sel]),
            (ood_ipt[ood_sel], ood_opt[ood_sel]))


def run(config, eval_only=False, log_dir='logs', device='cuda', plots=True):
    """Train (unless ``eval_only``), reload the bundle and score it;
    returns the Wasserstein result and the ID and OOD UEs."""
    run_dir = latest_log_dir(log_dir) if eval_only \
        else train(config, log_dir, device)
    model = load_model(f'{run_dir}/model.pth', device=device)
    id_data, ood_data = evaluation_data(config)
    evaluator = get_uncertainty_evaluator('wasserstein_distance')
    results = evaluator.evaluate(model, id_data, ood_data)
    print(results)
    _, id_ue = model(id_data[0], return_ue=True)
    _, ood_ue = model(ood_data[0], return_ue=True)
    id_ue, ood_ue = to_numpy(id_ue).ravel(), to_numpy(ood_ue).ravel()
    if plots:
        plt = pyplot()
        fig, ax = plt.subplots()
        ax.ecdf(id_ue, label='ID')
        ax.ecdf(ood_ue, label='OOD')
        ax.set_xlabel('uncertainty score')
        ax.legend()
        fig.savefig('uncertainty.png')
        plt.close(fig)
        print('wrote uncertainty.png')
    return results, id_ue, ood_ue


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Train and score a KDE surrogate of binomial options.')
    parser.add_argument('--config', default='config.yaml')
    parser.add_argument('--eval_only', action='store_true')
    parser.add_argument('--log_dir', default='logs')
    parser.add_argument('--device', default='cuda',
                        help="'cpu' to run on the CPU; default: the card")
    parser.add_argument('--no_plots', action='store_true',
                        help='Skip uncertainty.png (no matplotlib needed)')
    args = parser.parse_args(argv)
    run(config_reader.load_path(args.config), args.eval_only, args.log_dir,
        args.device, plots=not args.no_plots)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())

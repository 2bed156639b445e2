"""BO experiment driver: the train -> evaluate -> record loop, output
management and restart.

Counterpart of ``nnueehcs_tpu/driver.py``, with its on-disk contracts:

- per-trial directory ``<output>/<benchmark>/<dataset>/<method>/bo_trial_<N>``
  with ``ax_client.json``, ``ax_client_optimization_step.json``,
  ``trial_results.csv``, ``metrics.csv`` and ``model.pth``, and
  ``pareto_parameters.json`` in the last trial of a multi-metric run;
- restart scans for the first incomplete trial directory (complete = the
  three state files present) and reloads the BO client from the last
  complete one; either package resumes the other's tree;
- the ``trial_results.csv`` columns, index column ``trial``, written with
  ``csv`` (floats as their shortest round-trip repr, so that pandas reads
  the same values).

Differences from the JAX driver:

- the trial runs on one device: the card unless the caller passes
  ``device='cpu'`` or the config's trainer names ``accelerator: cpu`` (no
  fallback to the CPU without a card). The model is built there, the
  trainer trains there and the saved bundle is reloaded there;
- ``devices=`` of more than one device runs the cell on one process a
  device (``parallel.launch``: NCCL on cards, gloo on the CPU). Every rank
  runs every trial's body; rank 0 owns the BO client, the state files and
  the results tree and broadcasts each trial's parameters; the trainer
  trains on the configured mesh or ``{'dp': n}``, and evaluation shards
  over the same mesh. ``max_memory_usage`` is rank 0's allocator peak;
- the models compute in fp32, so the JAX driver's cast of the model to the
  dataset's dtype has no counterpart; ``eval_precision`` maps to the
  port's ``set_precision`` for the timed and UE passes;
- ``row['platform']`` is ``'gpu'`` or ``'cpu'``, from the torch device;
- ``enable_compilation_cache`` (XLA's persistent cache) has no counterpart:
  the CUDA kernels are built once per checkout (``ops/_build.py``).

``python -m nnueehcs_tpu_torch.driver --benchmark ... --uq_method ...
--config ... --dataset {tails,gaps} --output ... [--restart] [--device
cpu]`` runs one cell, as ``examples/bo_driven/bo.py`` does for the JAX
package.
"""
from __future__ import annotations

import argparse
import json
import re
import time
from dataclasses import dataclass
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import torch

from . import config as config_reader
from .bo import AxClient, ObjectiveProperties
from .data_utils import get_dataset, prepare_dataset_for_use
from .evaluation import UncertaintyEstimate, get_uncertainty_evaluator, to_numpy
from .model_builder import (EnsembleModelBuilder, KDEModelBuilder,
                            KNNKDEModelBuilder, DeltaUQMLPModelBuilder,
                            PAGERModelBuilder, MCDropoutModelBuilder,
                            MVEModelBuilder)
from .models.base import resolve_device
from .parallel.launch import launch
from .training import (Trainer, ModelSavingCallback, EarlyStopping,
                       DataLoader, load_model)
from .training.trainer import trainer_device
from .utility import (ResultsTable, find_latest_finished_trial,
                      union_columns, write_table)
from .utils.timing import device_sync, timed_passes


class OutputManager:
    """Per-trial output directory manager + restart-index scanner."""

    def __init__(self, directory_prefix, benchmark_name,
                 append_benchmark_name=True):
        self.benchmark_name = benchmark_name
        if append_benchmark_name:
            self.output_dir_name = f'{directory_prefix}_{benchmark_name}'
        else:
            self.output_dir_name = f'{directory_prefix}'
        self.output_dir_path = Path(self.output_dir_name)
        self.output_dir_path.mkdir(parents=True, exist_ok=True)

    def set_output_dir(self, output_dir):
        self.output_dir_path = output_dir

    @classmethod
    def get_datetime_prefix(cls):
        return datetime.now().strftime('%Y-%m-%d')

    def save_optimization_state(self, optimization_step, ax_client,
                                name='ax_client'):
        ax_client.save_to_json_file(f'{self.output_dir_path}/{name}.json')
        dat = {'optimization_step': optimization_step}
        with open(f'{self.output_dir_path}/{name}_optimization_step.json',
                  'w') as f:
            f.write(json.dumps(dat))

    def save_pareto_parameters(self, pareto_parameters,
                               name='pareto_parameters'):
        with open(f'{self.output_dir_path}/{name}.json', 'w') as f:
            f.write(pareto_parameters)

    def save_trial_results_dict(self, trial_results_dict,
                                name='trial_results'):
        """One row per trial, the index column ``trial`` first, then every
        column in the order rows first name it (a row without a column
        leaves its cell empty), as pandas' ``DataFrame.from_dict(...,
        orient='index').to_csv`` writes it."""
        columns = union_columns(trial_results_dict.values())
        write_table(f'{self.output_dir_path}/{name}.csv', ['trial'] + columns,
                    [[index] + [row.get(c) for c in columns]
                     for index, row in trial_results_dict.items()])

    def get_optimization_step(self):
        with open(f'{self.output_dir_path}/ax_client_optimization_step.json') as f:
            return json.load(f)['optimization_step']

    def get_optimization_state(self):
        with open(f'{self.output_dir_path}/ax_client.json') as f:
            return json.load(f)

    def get_optimization_state_file(self):
        return f'{self.output_dir_path}/ax_client.json'

    def get_trial_results(self) -> ResultsTable:
        return ResultsTable(f'{self.output_dir_path}/trial_results.csv')

    def get_output_dir(self):
        return self.output_dir_path

    def output_exists(self):
        return self.output_dir_path.exists()

    def run_completed(self, run_index):
        opt_dir = self.output_dir_path
        opt_dir_base, run_str = opt_dir.parent, opt_dir.name
        children = [x.name for x in opt_dir_base.iterdir()]
        run_prefix = self._get_run_prefix(run_str)

        target_dir = Path(f'{opt_dir_base}/{run_prefix}{run_index}')
        if target_dir.name not in children:
            return False
        names = [item.name for item in target_dir.iterdir()]
        return all(n in names for n in
                   ('ax_client.json', 'ax_client_optimization_step.json',
                    'trial_results.csv'))

    def get_restart_index(self):
        opt_dir_base = self.output_dir_path.parent
        max_restart_idx = 0
        for item in sorted(opt_dir_base.iterdir(),
                           key=lambda p: self._sort_key(p.name)):
            if self._is_run_directory(item.name):
                run_index = self._get_run_index(item.name)
                if self.run_completed(run_index):
                    max_restart_idx = max(max_restart_idx, run_index)
                    continue
                return run_index
        return max_restart_idx + 1

    @staticmethod
    def _sort_key(name):
        m = re.search(r'\d+', name)
        return int(m.group()) if m else -1

    def _get_run_index(self, run_str):
        return int(re.search(r'\d+', run_str).group())

    def _is_run_directory(self, run_str):
        return re.match(r'bo_trial_\d+', run_str) is not None

    def _get_run_prefix(self, run_dir):
        return re.compile(r'(\S+_)+(\d+)').match(run_dir).group(1)


@dataclass
class BOParameterWrapper:
    parameter_space: list
    parameter_constraints: list
    objectives: dict
    tracking_metric_names: list

    def get_parameter_names(self):
        return [p['name'] for p in self.parameter_space]


def get_params(config):
    parm_space = config['parameter_space']
    constraints = config.get('parameter_constraints', []) \
        if 'constraints' in config else []
    objectives_l = {}
    for c in config['objectives']:
        objectives_l[c['name']] = ObjectiveProperties(
            minimize=(c['type'] == 'minimize'))
    return BOParameterWrapper(parm_space, constraints, objectives_l,
                              config['tracking_metrics'])


UQ_METHOD_REGISTRY = {
    'ensemble': EnsembleModelBuilder,
    'kde': KDEModelBuilder,
    'knn_kde': KNNKDEModelBuilder,
    'delta_uq': DeltaUQMLPModelBuilder,
    'pager': PAGERModelBuilder,
    'mc_dropout': MCDropoutModelBuilder,
    'mve': MVEModelBuilder,
}


def register_uq_method(name: str, builder_cls) -> None:
    """Plugin hook: register a custom UQ method so configs/drivers can
    reference it by ``uq_method`` name."""
    UQ_METHOD_REGISTRY[name] = builder_cls


def get_model_builder_class(uq_method):
    try:
        return UQ_METHOD_REGISTRY[uq_method]
    except KeyError:
        raise ValueError(f'Unknown uq method {uq_method}')


def build_model(model_cfg, uq_config, uq_method, train_cfg, device='cuda'):
    builder_class = get_model_builder_class(uq_method)
    builder = builder_class(model_cfg['architecture'], uq_config[uq_method],
                            train_config=train_cfg, device=device)
    return builder.build()


def get_trainer(trainer_config, name, model, ue_method, dataset,
                version=None, log_dir='logs', device=None):
    # trainer.defer_checkpoint: serialize the best model once at fit end
    # instead of on every improvement
    defer = bool(trainer_config.get('defer_checkpoint', False))
    callbacks = [EarlyStopping(monitor='val_loss', min_delta=0.00, patience=30,
                               verbose=False, mode='min'),
                 ModelSavingCallback(monitor='val_loss',
                                     defer_serialization=defer)]
    extra = model.get_callbacks()
    if extra:
        callbacks.extend(extra)
    return Trainer(f'{name}/{dataset}/{ue_method}', trainer_config,
                   callbacks=callbacks, log_dir=log_dir, version=version,
                   device=device)


def evaluate(model, id_data, ood_data, evaluator,
             warmup: int = 5, trials: int = 10) -> dict:
    """Timed UE passes over ID, OOD and combined inputs, then the metrics
    (reference ``bo.py:205-280``): ``warmup`` passes on the ID inputs,
    then for each of combined, ID and OOD one warm pass and ``trials``
    timed ones (each synchronised), then one pass each on ID and OOD for
    the UEs and losses. The inputs are placed on the model's device once,
    as the reference's one ``.to(model.device)`` before its timing loops."""
    model.eval()
    id_opt = np.asarray(id_data.output)
    ood_opt = np.asarray(ood_data.output)
    id_host = np.asarray(id_data.input)
    ood_host = np.asarray(ood_data.input)
    id_ipt = torch.as_tensor(id_host, device=model.device)
    ood_ipt = torch.as_tensor(ood_host, device=model.device)

    for _ in range(warmup):
        device_sync(model(id_ipt, return_ue=True))

    combined = torch.cat((id_ipt, ood_ipt))
    combined_times = list(timed_passes(
        lambda: model(combined, return_ue=True), 1, trials))
    id_times = list(timed_passes(
        lambda: model(id_ipt, return_ue=True), 1, trials))
    ood_times = list(timed_passes(
        lambda: model(ood_ipt, return_ue=True), 1, trials))
    id_preds, id_ue = device_sync(model(id_ipt, return_ue=True))
    ood_preds, ood_ue = device_sync(model(ood_ipt, return_ue=True))

    id_loss = float(np.mean((to_numpy(id_preds) - id_opt) ** 2))
    ood_loss = float(np.mean((to_numpy(ood_preds) - ood_opt) ** 2))

    eval_results = [metric.evaluate(model, (id_host, id_opt),
                                    (ood_host, ood_opt))
                    for metric in evaluator.metrics]

    return {
        'id_ue': UncertaintyEstimate(id_ue),
        'ood_ue': UncertaintyEstimate(ood_ue),
        'ue_time': combined_times,
        'id_time': id_times,
        'ood_time': ood_times,
        'id_loss': id_loss,
        'ood_loss': ood_loss,
        'metric_results': eval_results,
    }


def get_restart(output_dir, name, dataset, uq_method):
    ld_name = f'{name}/{dataset}/{uq_method}'
    logdir = Trainer.get_default_logdir(output_dir, ld_name, 'bo_trial_0')
    opt_mgr = OutputManager(logdir, name, append_benchmark_name=False)
    restart_idx = opt_mgr.get_restart_index()
    if restart_idx == 0:
        raise ValueError(f'No restart index found in {logdir}')

    successful = restart_idx - 1
    logdir_trial = Trainer.get_default_logdir(output_dir, ld_name,
                                              f'bo_trial_{successful}')
    opt_mgr = OutputManager(logdir_trial, name, append_benchmark_name=False)
    ostep = opt_mgr.get_optimization_step()
    if ostep != successful:
        raise RuntimeError(f'{logdir_trial} records optimization step {ostep}, '
                         f'expected {successful}')
    ax_client = AxClient.load_from_json_file(
        opt_mgr.get_optimization_state_file())
    tresults = {}
    for record in opt_mgr.get_trial_results().records():
        index = record.pop('trial')
        tresults[index] = record
    return restart_idx, ax_client, tresults


def _platform(device: torch.device) -> str:
    return 'gpu' if device.type == 'cuda' else 'cpu'


def run_bo_experiment(benchmark, uq_method, config: dict, dataset, output,
                      restart: bool = False, devices=None,
                      device=None) -> dict:
    """The full BO loop for one (benchmark, uq_method, dataset-split) cell
    (reference ``bo.py:313-510``). Returns the trial-results dict.

    The trial runs on ``device`` (None: from the trainer's
    ``accelerator``, the card unless it names the CPU), or on ``devices``:
    one of them runs as ``device``; several run one rank each (see the
    module docstring), and rank 0's trial results are returned.
    """
    if devices is not None:
        devices = [resolve_device(d) for d in devices]
        if len(devices) > 1:
            return launch(_bo_rank, len(devices),
                          backend='nccl' if devices[0].type == 'cuda'
                          else 'gloo', devices=devices, timeout=None,
                          group_timeout=RANK_WAIT,
                          args=(benchmark, uq_method, config, dataset, output,
                                restart, [str(d) for d in devices]))
        device = devices[0]
    return _run_bo(benchmark, uq_method, config, dataset, output, restart,
                   device)


#: the longest a rank waits for the others at one collective (rank 0's BO
#: step and metrics run while the others wait for the next trial)
RANK_WAIT = timedelta(minutes=30)


def _bo_rank(rank, mesh, benchmark, uq_method, config, dataset, output,
             restart, devices):
    return _run_bo(benchmark, uq_method, config, dataset, output, restart,
                   mesh.device, mesh, devices)


def _run_bo(benchmark, uq_method, config, dataset, output, restart, device,
            mesh=None, devices=None) -> dict:
    """The BO loop on this process: alone, or as one rank of ``mesh``."""
    lead = mesh is None or mesh.rank == 0

    def share(obj):
        """Rank 0's ``obj`` on every rank."""
        return obj if mesh is None else mesh.broadcast_object(obj)

    trainer_cfg = dict(config['trainer'])
    if mesh is not None:
        trainer_cfg['mesh'] = trainer_cfg.get('mesh') or {'dp': mesh.size}
        trainer_cfg['devices'] = devices
    device = trainer_device(trainer_cfg.get('accelerator', 'auto'), device)
    training_cfg = dict(config['training'])
    model_cfg = config['benchmarks'][benchmark]['model']
    dataset_cfg = config['benchmarks'][benchmark]['datasets']
    uq_config = {k: dict(v) for k, v in config['uq_methods'].items()}
    bo_config = dict(config['bo_config'])
    bo_config.update(uq_config[uq_method])
    bo_config['parameter_space'] = (list(bo_config['parameter_space'])
                                    + list(training_cfg['parameter_space']))

    evaluators = get_uncertainty_evaluator(bo_config['evaluation_metric'])
    objectives = list(evaluators.get_training_objectives())
    metrics = list(evaluators.get_all_metrics())

    boc = dict(bo_config)
    boc['objectives'] = objectives
    boc['tracking_metrics'] = metrics
    del boc['evaluation_metric']
    bo_params = get_params(boc)
    training_cfg.pop('parameter_space', None)
    uq_config[uq_method].pop('parameter_space', None)
    # the timed and UE passes in this precision (e.g. 'bf16-mixed') while
    # training and checkpoints stay fp32
    eval_precision = uq_config[uq_method].pop('eval_precision', None)
    name = benchmark

    def fresh_client():
        client = AxClient()
        client.create_experiment(
            name='UE Tuning',
            parameters=bo_params.parameter_space,
            objectives=bo_params.objectives,
            tracking_metric_names=bo_params.tracking_metric_names,
            outcome_constraints=bo_params.parameter_constraints)
        return client

    bo_idx, trial_results, ax_client = 0, {}, None
    if lead and restart:
        try:
            bo_idx, ax_client, trial_results = get_restart(
                output, name, dataset, uq_method)
            print(f'Restarting from trial {bo_idx}')
        except (ValueError, FileNotFoundError) as e:
            print(f'Warning: {e}. Starting fresh optimization run.')
            bo_idx, trial_results, ax_client = 0, {}, fresh_client()
    elif lead:
        ax_client = fresh_client()
    bo_idx = share(bo_idx)

    # successes already recorded count toward the quota after a restart
    # (the reference zeroed its counter, so a restarted run could never
    # reach its quota)
    successful_trials = sum(
        1 for row in trial_results.values()
        if str(row.get('failed', False)).lower() not in ('true', '1', '1.0'))
    opt_manager = None
    for bo_trial in range(bo_idx,
                          bo_config['trials'] + bo_config['max_failures']):
        next_trial = None
        if lead and successful_trials < bo_config['trials']:
            next_trial = ax_client.get_next_trial()
        next_trial = share(next_trial)
        if next_trial is None:
            break
        trial, index = next_trial
        lr = trial.pop('learning_rate')
        bs = trial.pop('batch_size')
        wd = trial.pop('weight_decay', 0.0)
        training_cfg['learning_rate'] = lr
        training_cfg['batch_size'] = bs
        training_cfg['weight_decay'] = wd
        uq_config[uq_method].update(trial)

        dset = get_dataset(dataset_cfg, dataset)
        dset = prepare_dataset_for_use(dset, training_cfg)
        model = build_model(model_cfg, uq_config, uq_method, training_cfg,
                            device=device)
        trainer = get_trainer(trainer_cfg, name, model, uq_method, dataset,
                              version=f'bo_trial_{bo_trial}', log_dir=output,
                              device=device)
        if lead:
            opt_manager = OutputManager(trainer.logger.log_dir, benchmark,
                                        append_benchmark_name=False)

        train_dl = DataLoader(dset, batch_size=training_cfg['batch_size'],
                              shuffle=True, drop_last=True)
        test_dl = DataLoader(dset, batch_size=training_cfg['batch_size'],
                             shuffle=False)
        train_start = time.time()
        trainer.fit(model, train_dl, test_dl)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        training_time = time.time() - train_start

        if mesh is not None:
            mesh.barrier()                 # rank 0 has written the bundle
        model = load_model(f'{trainer.logger.log_dir}/model.pth',
                           device=trainer.device)
        if eval_precision:
            model.set_precision(eval_precision)
        if mesh is not None:
            model.attach_mesh(trainer.mesh)

        dset_id = get_dataset(dataset_cfg, dataset)
        dset_ood = get_dataset(dataset_cfg, dataset, is_ood=True)
        # OOD must be scaled by ID stats *first*: scaling is in place
        dset_ood = prepare_dataset_for_use(dset_ood, training_cfg,
                                           scaling_dset=dset_id)
        dset_id = prepare_dataset_for_use(dset_id, training_cfg)

        try:
            results = evaluate(model, dset_id, dset_ood, evaluators)
            id_ue = results['id_ue']
            ood_ue = results['ood_ue']
            metric_results = results['metric_results']

            n_id = np.asarray(dset_id.input).shape[0]
            n_ood = np.asarray(dset_ood.input).shape[0]
            id_ue_throughput = n_id / np.mean(results['id_time'])
            ood_ue_throughput = n_ood / np.mean(results['ood_time'])
            ue_throughput = (n_id + n_ood) / np.mean(results['ue_time'])

            trial_result = {}
            for metric, metric_result in zip(evaluators.metrics,
                                             metric_results):
                keys = list(metric_result.keys())
                if len(keys) > 1:
                    trial_result[metric.get_name()] = (
                        metric_result[keys[0]], metric_result[keys[1]])
                else:
                    trial_result[metric.get_name()] = (metric_result[keys[0]], 0)
            if lead:
                ax_client.complete_trial(trial_index=index,
                                         raw_data=trial_result)

            row = dict(trial)
            row['learning_rate'] = lr
            row['batch_size'] = bs
            row['weight_decay'] = wd
            row['ue_time'] = float(np.mean(results['ue_time']))
            row.update({k: v[0] for k, v in trial_result.items()})
            row['id_ue'] = id_ue.mean()
            row['ood_ue'] = ood_ue.mean()
            row['id_loss'] = results['id_loss']
            row['ood_loss'] = results['ood_loss']
            row['id_time'] = float(np.mean(results['id_time']))
            row['ood_time'] = float(np.mean(results['ood_time']))
            row['ue_throughput'] = ue_throughput
            row['id_ue_throughput'] = id_ue_throughput
            row['ood_ue_throughput'] = ood_ue_throughput
            row['train_time'] = training_time
            row['log_path'] = f'{trainer.logger.log_dir}'
            row['platform'] = _platform(device)
            row['failed'] = False
            row['error_message'] = ''
            trial_results[index] = row
            successful_trials += 1
        except (RuntimeError, ValueError, FloatingPointError) as e:
            print(f'Trial failed: {e}')
            row = dict(trial)
            row['learning_rate'] = lr
            row['batch_size'] = bs
            row['weight_decay'] = wd
            row['train_time'] = training_time
            row['log_path'] = f'{trainer.logger.log_dir}'
            for metric in evaluators.metrics:
                row[metric.get_name()] = float('nan')
            for col in ('ue_time', 'id_ue', 'ood_ue', 'id_loss', 'ood_loss',
                        'id_time', 'ood_time', 'ue_throughput',
                        'id_ue_throughput', 'ood_ue_throughput'):
                row[col] = float('nan')
            row['platform'] = _platform(device)
            row['failed'] = True
            row['error_message'] = str(e)
            trial_results[index] = row
            if lead:
                ax_client.log_trial_failure(trial_index=index)

        if lead:
            opt_manager.save_trial_results_dict(trial_results)
            opt_manager.save_optimization_state(index, ax_client)

    if not lead:
        return {}

    if opt_manager is None and trial_results:
        # quota already met at restart: no trial ran this invocation, but
        # the pareto export must still (re)generate into the latest
        # finished trial dir
        _, latest_dir = find_latest_finished_trial(
            Path(output) / name / dataset / uq_method)
        if latest_dir is not None:
            opt_manager = OutputManager(str(latest_dir), benchmark,
                                        append_benchmark_name=False)
    if len(bo_params.tracking_metric_names) > 1 and opt_manager is not None:
        pareto_results = ax_client.get_pareto_optimal_parameters(
            use_model_predictions=False)
        # the front over per-objective GP posterior means too, as the
        # reference's dual export
        pareto_predictions = ax_client.get_pareto_optimal_parameters(
            use_model_predictions=True)
        pareto = {'results': _jsonable(pareto_results),
                  'predictions': _jsonable(pareto_predictions)}
        opt_manager.save_pareto_parameters(json.dumps(pareto))

    return trial_results


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return float(obj)
    return obj


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='BO-driven UQ hyperparameter search: one (benchmark x '
                    'uq_method x dataset split) cell on the card.')
    parser.add_argument('--benchmark', required=True)
    parser.add_argument('--uq_method', required=True)
    parser.add_argument('--config', default='config.yaml')
    parser.add_argument('--dataset', choices=['tails', 'gaps'], required=True)
    parser.add_argument('--output', required=True,
                        help='Name of output directory')
    parser.add_argument('--restart', action='store_true',
                        help='Restart from a previous run found in output '
                             'directory')
    parser.add_argument('--device', default=None,
                        help="'cpu' to run on the CPU; default: the card, "
                             "unless the config's trainer names "
                             "accelerator: cpu")
    args = parser.parse_args(argv)
    config = config_reader.load_path(args.config)
    run_bo_experiment(args.benchmark, args.uq_method, config, args.dataset,
                      args.output, restart=args.restart, device=args.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())

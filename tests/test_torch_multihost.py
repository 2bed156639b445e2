"""The port's process-group initialisation (``parallel/multihost.py``) and
its way of starting a world (``parallel/launch.py``), against the JAX
package's ``multihost`` contract (tests/test_multihost.py): two
coordinated processes, ``initialize`` a no-op when called again,
``process_info``'s four keys, a sum across the processes. A world's
failure reaches the caller: the first rank's exception with its
traceback, or ``TimeoutError``, and every rank ends either way."""
import pytest
import torch

from nnueehcs_tpu.parallel import multihost as jmh
from nnueehcs_tpu_torch.parallel import launch, multihost
from nnueehcs_tpu_torch.parallel.launch import RemoteTraceback, free_port

import torch_parallel_cases as cases
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')


@pytest.fixture(scope='module')
def two_processes():
    return launch(cases.multihost_case, 2, threads=1, all_ranks=True,
                  timeout=cases.WORLD_TIMEOUT, args=(free_port(),))


@pytest.mark.parametrize('rank', [0, 1])
def test_two_process_initialize_twice_and_process_info(two_processes, rank):
    got = two_processes[rank]
    assert got['multihost'] is True
    assert got['info'] == {'process_index': rank, 'process_count': 2,
                           'local_devices': 1, 'global_devices': 2}
    assert set(got['info']) == set(jmh.process_info())


@pytest.mark.parametrize('rank', [0, 1])
def test_a_sum_and_a_gather_reach_every_process(two_processes, rank):
    assert two_processes[rank]['total'] == 3.0
    assert two_processes[rank]['gathered'] == [0, 1]


@pytest.mark.parametrize('rank', [0, 1])
def test_a_gloo_world_without_devices_leaves_the_device_to_the_caller(
        two_processes, rank):
    """``launch`` without ``devices`` over gloo gives the ranks no device:
    each entry point keeps its caller's (the card by default) instead of
    being moved to the CPU."""
    assert two_processes[rank]['device'] is None


def test_one_process_without_a_group():
    assert not multihost.is_multihost()
    assert multihost.process_info() == {'process_index': 0,
                                        'process_count': 1,
                                        'local_devices': 1,
                                        'global_devices': 1}


def test_initialize_reads_env_without_arguments(monkeypatch):
    """With no arguments the group reads ``env://`` (torchrun's and SLURM
    wrappers' variables); a second call is a no-op."""
    import torch.distributed as dist
    monkeypatch.setenv('MASTER_ADDR', '127.0.0.1')
    monkeypatch.setenv('MASTER_PORT', str(free_port()))
    monkeypatch.setenv('WORLD_SIZE', '1')
    monkeypatch.setenv('RANK', '0')
    try:
        multihost.initialize(backend='gloo')
        multihost.initialize(backend='gloo')
        assert dist.is_initialized() and dist.get_backend() == 'gloo'
        assert multihost.process_info()['process_count'] == 1
        assert not multihost.is_multihost()
    finally:
        multihost.shutdown()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match='num_processes and process_id'):
        multihost.initialize('127.0.0.1:1', backend='gloo')
    assert multihost.default_backend() == (
        'nccl' if torch.cuda.is_available() else 'gloo')


def test_a_failing_rank_raises_in_the_caller_with_its_traceback():
    with pytest.raises(KeyError, match='rank 1 fails on purpose') as info:
        launch(cases.failing_case, 2, threads=1, timeout=cases.WORLD_TIMEOUT)
    cause = info.value.__cause__
    assert isinstance(cause, RemoteTraceback)
    assert 'rank 1:' in str(cause) and 'failing_case' in str(cause)


def test_a_world_past_its_timeout_is_ended():
    import multiprocessing
    with pytest.raises(TimeoutError, match='did not finish within 8'):
        launch(cases.sleeping_case, 2, threads=1, timeout=8)
    assert not multiprocessing.active_children()


def test_a_world_needs_a_rank():
    with pytest.raises(ValueError, match='at least one rank'):
        launch(cases.failing_case, 0)

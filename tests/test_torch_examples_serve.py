"""The port's HTTP server (``nnueehcs_tpu_torch/examples/serving/serve.py``)
against the JAX one (``examples/serving/serve.py``'s ``make_handler`` over
the JAX ``Predictor``) on the same ``model.pth`` bundle, both in-process on
127.0.0.1: the same JSON keys, answers within the parity bar (1e-5), the
same error codes; and the port's profiling helpers
(``nnueehcs_tpu_torch/utils/profiling.py``) against the JAX ones on the
CPU."""
import json
import os
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nnueehcs_tpu.model_builder import (EnsembleModelBuilder,
                                        MVEModelBuilder)
from nnueehcs_tpu.serving import Predictor as JaxPredictor
from nnueehcs_tpu.training import save_model
from nnueehcs_tpu.utils import profiling as jax_profiling
from nnueehcs_tpu_torch.examples.serving import serve
from nnueehcs_tpu_torch.serving import Predictor
from nnueehcs_tpu_torch.utils import profiling

from torch_parity import descr

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
BUCKETS = (32, 256)
BUILDERS = {'ensemble': (EnsembleModelBuilder, {'num_models': 3}),
            'mve': (MVEModelBuilder, {'min_variance': 1e-6})}


def jax_make_handler():
    directory = str(REPO / 'examples' / 'serving')
    if directory not in sys.path:
        sys.path.insert(0, directory)
    from serve import make_handler
    return make_handler


def start(handler):
    httpd = ThreadingHTTPServer(('127.0.0.1', 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, f'http://127.0.0.1:{httpd.server_address[1]}'


@pytest.fixture(scope='module', params=sorted(BUILDERS))
def servers(request, tmp_path_factory):
    """``(jax_url, port_url)``: both servers on one saved bundle."""
    builder, uq = BUILDERS[request.param]
    model = builder(descr(), uq, train_config={'loss': 'l1_loss'}).build()
    path = str(tmp_path_factory.mktemp('bundle') / 'model.pth')
    save_model(model, path)
    running = [start(jax_make_handler()(JaxPredictor(path, buckets=BUCKETS))),
               start(serve.make_handler(Predictor(path, buckets=BUCKETS,
                                                  device='cpu')))]
    yield request.param, [url for _, _, url in running]
    for httpd, thread, _ in running:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def call(url, payload=None, raw=None, method=None):
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    request = urllib.request.Request(
        url, data=data, method=method,
        headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(request, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz_matches_jax(servers):
    name, urls = servers
    (js, jbody), (ps, pbody) = [call(u + '/healthz') for u in urls]
    assert js == ps == 200
    assert pbody == jbody
    assert pbody['uq_method'] == name and pbody['buckets'] == list(BUCKETS)


@pytest.mark.parametrize('rows', [1, 5, 300])
def test_predict_matches_jax(servers, rows):
    _, urls = servers
    x = np.random.default_rng(rows).normal(size=(rows, 5)) \
        .astype(np.float32).tolist()
    (js, jbody), (ps, pbody) = [call(u + '/predict', {'inputs': x})
                                for u in urls]
    assert js == ps == 200
    assert sorted(pbody) == sorted(jbody) == ['latency_ms', 'predictions',
                                              'uncertainty']
    for key in ('predictions', 'uncertainty'):
        assert len(pbody[key]) == len(jbody[key]) == rows
        np.testing.assert_allclose(pbody[key], jbody[key], atol=TOL,
                                   rtol=TOL)
    assert pbody['latency_ms'] >= 0


BAD_REQUESTS = {
    'wrong_width': ('/predict', {'inputs': [[1.0, 2.0]]}, None, None),
    'one_dimensional': ('/predict', {'inputs': [1.0] * 5}, None, None),
    'no_inputs_key': ('/predict', {'x': [[0.0] * 5]}, None, None),
    'not_an_object': ('/predict', [[0.0] * 5], None, None),
    'not_json': ('/predict', None, b'{not json', None),
    'ragged_rows': ('/predict', {'inputs': [[0.0] * 5, [0.0]]}, None, None),
    'unknown_get': ('/nope', None, None, 'GET'),
    'unknown_post': ('/nope', {'inputs': []}, None, None),
}


@pytest.mark.parametrize('case', sorted(BAD_REQUESTS))
def test_error_codes_match_jax(servers, case):
    _, urls = servers
    path, payload, raw, method = BAD_REQUESTS[case]
    (js, jbody), (ps, pbody) = [call(u + path, payload, raw, method)
                                for u in urls]
    assert ps == js and ps in (400, 404)
    assert sorted(pbody) == sorted(jbody) and 'error' in pbody


def test_main_serves_on_the_card_unless_asked(monkeypatch, tmp_path):
    """``--device`` defaults to the card, which must exist: without one the
    command raises before it serves."""
    model = EnsembleModelBuilder(descr(), {'num_models': 2},
                                 train_config={'loss': 'l1_loss'}).build()
    path = str(tmp_path / 'model.pth')
    save_model(model, path)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        serve.main(['--model', path, '--port', '0'])


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------
def test_profile_trace_names_the_span_on_the_cpu(tmp_path):
    with profiling.profile_trace(str(tmp_path), device='cpu') as prof:
        with profiling.annotate('uq_request', device='cpu'):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    trace = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    names = {e.get('name') for e in trace['traceEvents']}
    assert 'uq_request' in names
    assert any('mm' in str(n) for n in names)


def test_profile_trace_disabled_writes_nothing(tmp_path):
    with profiling.profile_trace(str(tmp_path / 'p'), enabled=False,
                                 device='cpu') as prof:
        pass
    assert prof is None and not (tmp_path / 'p').exists()


def test_device_memory_stats_on_the_cpu_matches_jax():
    assert profiling.device_memory_stats('cpu') == {} == \
        jax_profiling.device_memory_stats(jax.devices('cpu')[0])


def test_live_array_bytes_counts_cuda_tensors_only():
    with pytest.raises(ValueError, match='CUDA'):
        profiling.live_array_bytes('cpu')


@pytest.mark.parametrize('helper', ['profile_trace', 'annotate',
                                    'device_memory_stats',
                                    'live_array_bytes'])
def test_profiling_defaults_to_the_card(monkeypatch, tmp_path, helper):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        if helper == 'profile_trace':
            with profiling.profile_trace(str(tmp_path)):
                pass
        elif helper == 'annotate':
            with profiling.annotate('span'):
                pass
        else:
            getattr(profiling, helper)()
    assert not os.listdir(tmp_path)

"""Dataset layer: HDF5, ARFF and character-delimited readers with
percentile ID/OOD partitioning, subset slicing, dtype conversion and
min-max scaling.

Counterpart of ``nnueehcs_tpu/data_utils.py``, with the same contracts:

- percentile strings like ``'[0, 30], [60, 100]'`` parsed with the same
  regex;
- partition semantics: quantiles over the *whole* output; a range with
  lower bound 0 selects ``y <= q(upper)``, otherwise
  ``q(lower) < y <= q(upper)``;
- the hook order after a reader loads its arrays: slice, then percentile
  partition, then dtype conversion;
- ``train_test_split(seed)`` selects the JAX package's rows;
- min-max scaling by the *global* min and max, optionally taken from
  another dataset so that OOD data is scaled by the ID statistics.

Data stays in host numpy arrays; ``to(device)`` turns them into torch
tensors on that device. ``h5py`` (HDF5), ``scipy.io.arff`` (ARFF) and
``ml_dtypes`` (a ``bfloat16`` dtype) are imported by the reader that needs
them. A delimited file goes through the native parser
(:mod:`nnueehcs_tpu_torch.native`) and, where that declines, through
numpy's ``loadtxt`` (the JAX package uses pandas there); the reader's
``parser`` attribute says which (``'native'`` or ``'numpy'``). Configs are
read with :mod:`nnueehcs_tpu_torch.config`.
"""
from __future__ import annotations

import csv
import re

import numpy as np

from . import config as _config

percentile_re = re.compile(r'(?:\[(\d+),\s{0,1}(\d+)\],{0,1})')

_DTYPE_MAP = {
    'float16': np.float16, 'float32': np.float32, 'float64': np.float64,
    'bfloat16': 'bfloat16',  # resolved lazily via ml_dtypes
    'int8': np.int8, 'int16': np.int16, 'int32': np.int32, 'int64': np.int64,
    'uint8': np.uint8,
    'float': np.float32, 'double': np.float64, 'half': np.float16,
    'long': np.int64, 'int': np.int32, 'short': np.int16,
}


# the fields pandas' read_csv reads as NaN by default
_NA_FIELDS = frozenset((
    '', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
    '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a',
    'nan', 'null'))


def _number(field: str) -> float:
    """One delimited field (quotes already stripped) as pandas reads a
    numeric column: a missing-value marker is NaN, anything else a Python
    float literal without digit separators, which pandas does not take."""
    if field in _NA_FIELDS:
        return np.nan
    if '_' in field:
        raise ValueError(f'not a number: {field!r}')
    return float(field)


def _resolve_dtype(name: str):
    dt = _DTYPE_MAP.get(name)
    if dt == 'bfloat16':
        import ml_dtypes
        return ml_dtypes.bfloat16
    if dt is None:
        raise ValueError(f'Unknown dtype {name!r}')
    return dt


class DatasetCommon:
    """Shared behaviour for all dataset readers.

    Subclasses load ``self.input`` / ``self.output`` (2-D numpy arrays) in
    their ``__init__``; the ``__init_subclass__`` hook then automatically runs
    slice → percentile-partition → dtype-conversion, preserving the
    reference's post-init chain (reference ``data_utils.py:16-24``).
    """

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        original_init = cls.__init__

        def new_init(self, *args, **kw):
            original_init(self, *args, **kw)
            self._apply_slice()
            self._percentile_partition()
            self._dtype_conversion()
        cls.__init__ = new_init

    def __len__(self):
        return self.len

    @property
    def len(self):
        return len(self.input)

    def __getitem__(self, idx):
        return (self.input[idx], self.output[idx])

    def to(self, device):
        """Turn the arrays into torch tensors on ``device`` (None leaves
        them as they are)."""
        import torch
        from .models.base import resolve_device
        if device is None:
            return self
        device = resolve_device(device)
        self.input = torch.as_tensor(np.asarray(self.input), device=device)
        self.output = torch.as_tensor(np.asarray(self.output), device=device)
        return self

    def input_as_array(self):
        return self.input

    def output_as_array(self):
        return self.output

    # kept under the reference's names
    input_as_torch_tensor = input_as_array
    output_as_torch_tensor = output_as_array

    def get_percentiles(self):
        try:
            percs = self.kwargs['percentiles']
        except KeyError:
            return [(0, 100)]
        parsed = percentile_re.findall(percs)
        return [(int(p[0]), int(p[1])) for p in parsed]

    def percentile_partition(self, percentiles):
        input_arr = np.asarray(self.input_as_array())
        output_arr = np.asarray(self.output_as_array())

        if output_arr.ndim > 2:
            return input_arr, output_arr

        unique_percentiles = sorted(
            set(p for range_pair in percentiles for p in range_pair))
        # torch.quantile uses linear interpolation — numpy's default matches.
        percentile_values = {
            q: np.quantile(output_arr.astype(np.float64), q / 100)
            for q in unique_percentiles
        }

        mask = np.zeros(len(output_arr), dtype=bool)
        for lower, upper in percentiles:
            lower_value = percentile_values[lower]
            upper_value = percentile_values[upper]
            flat = output_arr.reshape(len(output_arr), -1)[:, 0] \
                if output_arr.ndim > 1 else output_arr
            if lower == 0:
                mask |= (flat <= upper_value)
            else:
                mask |= ((flat > lower_value) & (flat <= upper_value))

        return input_arr[mask], output_arr[mask]

    def _percentile_partition(self):
        self.input, self.output = self.percentile_partition(self.get_percentiles())

    def _dtype_conversion(self):
        try:
            dt = self.kwargs['dtype']
        except KeyError:
            return
        np_dt = _resolve_dtype(dt)
        self.input = np.asarray(self.input).astype(np_dt)
        self.output = np.asarray(self.output).astype(np_dt)

    def _apply_slice(self):
        try:
            subset = self.kwargs['subset']
        except KeyError:
            return
        slc = slice(subset.get('start', 0), subset['stop'], subset.get('step', 1))
        self.input = self.input[slc]
        self.output = self.output[slc]

    @property
    def dtype(self):
        return np.asarray(self.input).dtype

    def train_test_split(self, test_proportion: float, seed: int = 0):
        """Random split into (train_indices, test_indices) views."""
        test_size = int(len(self) * test_proportion)
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self))
        test_idx, train_idx = perm[:test_size], perm[test_size:]
        return DatasetView(self, train_idx), DatasetView(self, test_idx)


class DatasetView:
    """A row-subset view of a dataset (replacement for torch random_split)."""

    def __init__(self, base, indices):
        self.base = base
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.base[self.indices[idx]]

    @property
    def input(self):
        return np.asarray(self.base.input)[self.indices]

    @property
    def output(self):
        return np.asarray(self.base.output)[self.indices]


class HDF5Dataset(DatasetCommon):
    """Reads ``group/input_dataset`` + ``group/output_dataset`` from an HDF5
    file; squeezes a leading dimension of 1 with a warning."""

    def __init__(self, path: str, group_name: str,
                 input_dataset: str, output_dataset: str, **kwargs):
        super().__init__(**kwargs)
        self.path = path
        self.group_name = group_name
        self.input_dataset = input_dataset
        self.output_dataset = output_dataset
        self.input, self.output = self.get_datasets(
            path, group_name, input_dataset, output_dataset)
        assert len(self.input) == len(self.output)

    def get_datasets(self, filename, group_name, ipt_dataset, opt_dataset):
        import h5py
        with h5py.File(filename, 'r') as f:
            group = f[group_name]
            ipt = group[ipt_dataset]
            opt = group[opt_dataset]
            if ipt.shape[0] == 1:
                print(f"WARNING: Found left dimension of 1 in shape {ipt.shape},"
                      f" assuming this is not necessary and removing it."
                      f" Reshaping to {ipt.shape[1:]}")
                ipt = ipt[0]
                opt = opt[0]
            return np.asarray(ipt), np.asarray(opt)

    @property
    def shape(self):
        return self.input.shape


class ARFFDataSet(DatasetCommon):
    """ARFF reader; the last column is the regression target."""

    def __init__(self, path: str, **kwargs):
        super().__init__(**kwargs)
        self.path = path
        ipt, opt = self.read_arff_file(path)
        self.input, self.output = np.asarray(ipt), np.asarray(opt)

    def read_arff_file(self, path):
        """The columns of ``scipy.io.arff``'s record array as one 2-D array,
        as the JAX package's ``pd.DataFrame(data).values`` gives them:
        float64 when every attribute is numeric, else objects."""
        from scipy.io import arff
        data, meta = arff.loadarff(path)
        columns = [data[name] for name in meta.names()]
        numeric = all(c.dtype.kind == 'f' for c in columns)
        table = np.empty((len(data), len(columns)),
                         np.float64 if numeric else object)
        for j, c in enumerate(columns):
            table[:, j] = c
        return table[:, :-1], np.expand_dims(table[:, -1], -1)

    @property
    def shape(self):
        return self.input.shape


class CharacterDelimitedDataset(DatasetCommon):
    """Delimited-text reader with csv.Sniffer-based header detection,
    including the whitespace-delimiter rewrite trick."""

    def __init__(self, path, delimiter: str, **kwargs):
        super().__init__(**kwargs)
        self.path = path
        self.delimiter = delimiter
        ipt, opt = self.read_file(path, delimiter)
        self.input, self.output = np.asarray(ipt), np.asarray(opt)

    def read_file(self, path, delimiter):
        has_header = self.file_has_header(path, delimiter)
        from .native import load_delimited
        data = load_delimited(path, delimiter,
                              skip_rows=1 if has_header else 0)
        self.parser = 'native'
        if data is None:
            data = self._loadtxt(path, delimiter, has_header)
            self.parser = 'numpy'
        return data[:, :-1], np.expand_dims(data[:, -1], -1)

    @staticmethod
    def _loadtxt(path, delimiter, has_header):
        """A numeric table through numpy: whitespace runs for ``\\s+`` and
        ``' '``, else the delimiter itself. As pandas reads a table: a
        field in double quotes is read without them, and an empty field or
        one of pandas' missing-value markers (``NA``, ``null``, ...) is
        NaN. A ragged row or a field that is not a number raises
        ``ValueError``."""
        if hasattr(path, 'seek'):
            path.seek(0)
        sep = None if delimiter in (r'\s+', ' ') else delimiter
        return np.loadtxt(path, delimiter=sep, skiprows=1 if has_header else 0,
                          ndmin=2, dtype=np.float64, comments=None,
                          quotechar='"', converters=_number)

    def file_has_header(self, path, sep):
        if isinstance(path, str):
            with open(path, 'r') as f:
                sample_lines = [f.readline() for _ in range(5)]
        else:
            pos = path.tell()
            path.seek(0)
            sample_lines = [path.readline() for _ in range(5)]
            path.seek(pos)

        processed = []
        for line in sample_lines:
            if sep == r'\s+':
                processed.append(re.sub(r'(?<=\S)\s+(?=\S)', ',', line.rstrip('\n')))
            else:
                processed.append(line.rstrip('\n').replace(sep, ','))
        sample = '\n'.join(processed)

        try:
            return csv.Sniffer().has_header(sample)
        except csv.Error:
            return False

    @property
    def shape(self):
        return self.input.shape


def get_dataset_from_config(config, dataset_name):
    dset_details = dict(config[dataset_name])
    fmt = dset_details.pop('format')
    if fmt == 'hdf5':
        return HDF5Dataset(**dset_details)
    elif fmt == 'arff':
        return ARFFDataSet(**dset_details)
    elif fmt == 'character_delimited':
        return CharacterDelimitedDataset(**dset_details)
    raise ValueError(f'Unknown dataset format {fmt}')


def read_dataset_from_yaml(filename, dataset_name: str):
    """The dataset ``dataset_name`` of a config file (a path, or a file
    object such as ``io.StringIO``), read with
    :mod:`nnueehcs_tpu_torch.config`."""
    try:
        with open(filename, 'r') as f:
            config = _config.safe_load(f)
    except TypeError:
        config = _config.safe_load(filename)
    return get_dataset_from_config(config['datasets'], dataset_name)


def get_id_datset_name(dataset_name):
    return dataset_name + '_id'


def get_ood_dataset_name(dataset_name):
    return dataset_name + '_ood'


def get_dataset(dataset_cfg, dataset_name, is_ood=False):
    name = get_ood_dataset_name(dataset_name) if is_ood \
        else get_id_datset_name(dataset_name)
    return get_dataset_from_config(dataset_cfg, name)


def prepare_dataset_for_use(dset, training_cfg, scaling_dset=None):
    """Global min-max scaling in place; when ``scaling_dset`` is given its
    statistics are used (OOD scaled by the ID statistics, so the OOD set
    must be scaled before the ID set is)."""
    ipt = np.asarray(dset.input)
    opt = np.asarray(dset.output)
    if scaling_dset is None:
        scale_ipt, scale_opt = ipt, opt
    else:
        scale_ipt = np.asarray(scaling_dset.input)
        scale_opt = np.asarray(scaling_dset.output)

    if training_cfg.get('scaling') is True:
        dset.output = (opt - scale_opt.min()) / (scale_opt.max() - scale_opt.min())
        dset.input = (ipt - scale_ipt.min()) / (scale_ipt.max() - scale_ipt.min())
    return dset

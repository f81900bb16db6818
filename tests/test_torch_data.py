"""The port's record pipeline (kubeflow_tpu_torch/data/) against the JAX
package's kubeflow_tpu/data/.

The same KFTR shards and seed must give exactly the same batches (equal
arrays, in the same order) through both packages' ``tensor_batches``,
on the native core's path (built by each package on its own) and on the
pure-Python path, after ``seek``, and through a transient read fault.
Files written by either writer are the same bytes and read by either
reader.
"""

from pathlib import Path

import numpy as np
import pytest

from kubeflow_tpu.data import loader as jax_loader
from kubeflow_tpu_torch.data import loader
from kubeflow_tpu_torch.testing import faults

SEQ = 16


def _examples(n=44, seed=0):
    rng = np.random.RandomState(seed)
    for i in range(n):
        yield {"tokens": rng.randint(0, 1000, size=(SEQ,)).astype(np.int32),
               "id": np.asarray(i, np.int64)}


@pytest.fixture
def shards(tmp_path):
    return loader.write_example_shards(_examples(), tmp_path / "port",
                                       examples_per_shard=10)


def _take(batches, n):
    out = []
    for batch in batches:
        out.append(batch)
        if len(out) == n:
            break
    return out


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("shuffle", [0, 8])
def test_same_files_and_seed_give_the_same_batches(shards, path, shuffle):
    kw = (dict(num_threads=1) if path == "native"
          else dict(force_python=True))

    def batches(pkg):
        ds = pkg.RecordDataset(shards, shuffle_buffer=shuffle, seed=3,
                               repeat=2, **kw)
        return list(pkg.tensor_batches(ds, 4))

    want = batches(jax_loader)
    _assert_same_batches(batches(loader), want)
    assert len(want) == 2 * 44 // 4
    if path == "native":
        lib = loader._native_lib()
        assert lib is not None
        built = sorted((Path(loader.__file__).parent / "_build").glob(
            "libkft_data-*.so"))
        assert built, "the port builds its own native core"


def test_files_are_the_same_bytes_and_read_by_either_reader(tmp_path):
    ours = loader.write_example_shards(_examples(12), tmp_path / "port",
                                       examples_per_shard=5)
    theirs = jax_loader.write_example_shards(_examples(12),
                                             tmp_path / "jax",
                                             examples_per_shard=5)
    assert [p.read_bytes() for p in ours] == [p.read_bytes()
                                              for p in theirs]
    for reader, files in ((loader, theirs), (jax_loader, ours)):
        got = [reader.decode_example(r) for f in files
               for r in reader.read_records(f)]
        want = list(_examples(12))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
    payload = loader.encode_example({"tokens": np.arange(3)})
    assert payload == jax_loader.encode_example({"tokens": np.arange(3)})


@pytest.mark.parametrize("shuffle", [0, 8])
def test_seek_skips_the_same_batches(shards, shuffle):
    """Unshuffled python-path shards take the header-walk skip, shuffled
    ones drain: both land where the JAX package's seek lands."""
    def batches(pkg):
        ds = pkg.RecordDataset(shards, shuffle_buffer=shuffle, seed=1,
                               repeat=-1, force_python=True)
        it = pkg.tensor_batches(ds, 4)
        it.seek(7)
        return _take(it, 6)

    _assert_same_batches(batches(loader), batches(jax_loader))


def test_a_transient_read_fault_is_retried_in_place(shards):
    def batches(pkg):
        ds = pkg.RecordDataset(shards, force_python=True)
        return list(pkg.tensor_batches(ds, 4, retry_backoff_s=0.0,
                                       retry_backoff_max_s=0.0))

    want = batches(jax_loader)
    with faults.injected("data.next:raise*2") as inj:
        got = batches(loader)
        assert inj.fired("data.next") == len(want) + 1 + 2
    _assert_same_batches(got, want)
    with faults.injected("data.next:raise"):
        with pytest.raises(loader.DataError):
            batches(loader)

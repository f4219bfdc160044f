"""The dataset registry and loaders against the JAX package's.

Every array a loader returns must equal the JAX loader's bit for bit
(values and dtypes): the synthetic LR tasks, the synthetic stand-ins of
mnist, femnist, fed_cifar100 and cifar10/100/cinic10 (homo and hetero), and
the file readers on tiny files each test writes itself (MNIST's LEAF JSON,
the CIFAR-10 and CIFAR-100 pickles, CINIC-10's ImageFolder tree and the
femnist h5 files).
"""

import json
import pickle
import sys

import numpy as np
import pytest

import fedml_tpu.data as jax_data
from fedml_tpu_torch.data import known_datasets, load_dataset, register_dataset

FIELDS = ("train_x", "train_y", "train_mask", "train_counts", "test_x", "test_y", "test_mask")


def _both(name, **kw):
    args = {**dict(client_num_in_total=6, num_clients=6, batch_size=8, seed=3,
                   data_dir="/nonexistent-data-dir"), **kw}
    return load_dataset(name, **args), jax_data.load_dataset(name, **args)


def _assert_same(got, want):
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert (got.class_num, got.task, got.name) == (want.class_num, want.task, want.name)
    assert (got.train_data_num, got.test_data_num) == (want.train_data_num, want.test_data_num)


@pytest.mark.parametrize("name", ["synthetic_1_1", "synthetic_0_0", "synthetic_0.5_0.5"])
def test_synthetic_lr_is_bit_equal(name):
    _assert_same(*_both(name))


@pytest.mark.parametrize("name", ["mnist", "femnist", "fed_cifar100"])
def test_natural_partition_stand_ins_are_bit_equal(name):
    _assert_same(*_both(name))


@pytest.mark.parametrize("method", ["homo", "hetero"])
@pytest.mark.parametrize("name", ["cifar10", "cifar100", "cinic10"])
def test_cifar_stand_ins_are_bit_equal(name, method):
    got, want = _both(name, partition_method=method, partition_alpha=0.5)
    _assert_same(got, want)
    assert got.train_x.shape[2:] == (32, 32, 3)


def test_registry(monkeypatch, tmp_path):
    import fedml_tpu_torch.data as data

    names = known_datasets()
    assert set(names) == set(jax_data.known_datasets())   # every name loads
    with pytest.raises(KeyError):
        load_dataset("no-such-dataset")
    # hetero-fix keeps its map file in data_dir (the stand-in's name)
    ds = load_dataset("cifar10", partition_method="hetero-fix", client_num_in_total=4,
                      data_dir=str(tmp_path))
    assert ds.num_clients == 4 and len(list(tmp_path.glob("*_partition_4_a0.5_s0.npz"))) == 1

    monkeypatch.setattr(data, "_LOADERS", dict(data._LOADERS))

    @register_dataset("torch-test-alias-a", "torch-test-alias-b")
    def _loader(**kw):
        return kw

    assert load_dataset("torch-test-alias-b", x=1) == {"x": 1}


def test_mnist_leaf_json_reader_is_bit_equal(tmp_path):
    rng = np.random.default_rng(0)
    for split, users, n in (("train", ["f_02", "f_00", "f_01"], 7), ("test", ["f_00", "f_02"], 3)):
        (tmp_path / split).mkdir()
        for part, chunk in enumerate((users[:2], users[2:])):
            blob = {"users": chunk, "user_data": {
                u: {"x": rng.random((n + i, 784)).round(4).tolist(),
                    "y": rng.integers(0, 10, n + i).tolist()} for i, u in enumerate(chunk)}}
            (tmp_path / split / f"part{part}.json").write_text(json.dumps(blob))
    got, want = _both("mnist", data_dir=str(tmp_path))
    assert got.name == "mnist" and got.num_clients == 3
    _assert_same(got, want)


def _pickle(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def test_cifar10_pickle_reader_is_bit_equal(tmp_path):
    rng = np.random.default_rng(1)
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    for i in range(1, 6):
        _pickle(d / f"data_batch_{i}", {b"data": rng.integers(0, 256, (8, 3072), np.uint8),
                                        b"labels": rng.integers(0, 10, 8).tolist()})
    _pickle(d / "test_batch", {b"data": rng.integers(0, 256, (6, 3072), np.uint8),
                               b"labels": rng.integers(0, 10, 6).tolist()})
    got, want = _both("cifar10", data_dir=str(tmp_path), partition_method="homo")
    assert got.name == "cifar10" and got.train_data_num == 40
    _assert_same(got, want)


def test_cifar100_pickle_reader_is_bit_equal(tmp_path):
    rng = np.random.default_rng(2)
    d = tmp_path / "cifar-100-python"
    d.mkdir()
    for split, n in (("train", 30), ("test", 5)):
        _pickle(d / split, {b"data": rng.integers(0, 256, (n, 3072), np.uint8),
                            b"fine_labels": rng.integers(0, 100, n).tolist()})
    got, want = _both("cifar100", data_dir=str(tmp_path), partition_method="homo")
    assert got.name == "cifar100" and got.class_num == 100
    _assert_same(got, want)


def test_cinic10_image_folder_reader_is_bit_equal(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(4)
    for split, per_class in (("train", 2), ("test", 1)):
        for c in range(10):
            cdir = tmp_path / split / f"class{c}"
            cdir.mkdir(parents=True)
            for i in range(per_class):
                Image.fromarray(rng.integers(0, 256, (32, 32, 3), np.uint8)).save(
                    cdir / f"{i}.png")
    got = load_dataset("cinic10", data_dir=str(tmp_path), client_num_in_total=4,
                       partition_method="homo", batch_size=4, seed=0)
    assert (tmp_path / "cinic10_decoded.npz").exists()       # the decoded cache
    want = jax_data.load_dataset("cinic10", data_dir=str(tmp_path), client_num_in_total=4,
                                 partition_method="homo", batch_size=4, seed=0)
    assert got.name == "cinic10" and got.train_data_num == 20
    _assert_same(got, want)


def _write_h5(path, key, clients, shape, rng):
    import h5py

    with h5py.File(path, "w") as f:
        ex = f.create_group("examples")
        for cid, n in clients:
            g = ex.create_group(cid)
            g.create_dataset(key, data=rng.random((n, *shape)).astype(np.float32))
            g.create_dataset("label", data=rng.integers(0, 62, n))


def test_femnist_h5_reader_is_bit_equal_and_needs_h5py(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    _write_h5(tmp_path / "fed_emnist_train.h5", "pixels", [("a", 5), ("b", 9), ("c", 3)],
              (28, 28), rng)
    _write_h5(tmp_path / "fed_emnist_test.h5", "pixels", [("a", 2), ("b", 4)], (28, 28), rng)
    got, want = _both("femnist", data_dir=str(tmp_path))
    assert got.name == "femnist" and got.num_clients == 3
    _assert_same(got, want)
    # the files are there but h5py is not: raise, never fall back
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        load_dataset("femnist", data_dir=str(tmp_path))

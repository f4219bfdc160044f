"""The StackOverflow and ImageNet / Landmarks loaders and the ``hetero-fix``
partition against the JAX package on the CPU. Every array is numpy on both
sides, so each comparison is exact.

- ``stackoverflow_lr`` / ``stackoverflow_nwp`` on a tiny TFF-layout corpus
  written here (``examples/<cid>/tokens|title|tags``, the word and tag
  count tables), train and test h5 (the JAX package's own test corpus,
  tests/test_data_extra.py::test_stackoverflow_real_h5_paths), and their
  synthetic stand-ins (10,000 -> 500 multilabel tags; 20 tokens over
  10,004 ids); a mounted h5 without its vocab tables raises.
- ``ILSVRC2012`` / ``imagenet`` (a folder a class) and ``gld23k`` /
  ``gld160k`` (the csv federation) on tiny image trees written here, and
  their synthetic fall-backs.
- ``hetero-fix``: the map file is made once (the Dirichlet split) and read
  back, JAX's file read by the port and the port's by JAX; a map of another
  client count or one that does not cover the records (a stale map) raises.
"""

import json

import numpy as np
import pytest

import fedml_tpu.core.partition as jpart
import fedml_tpu.data as jax_data
import fedml_tpu_torch.core.partition as tpart
from fedml_tpu_torch.data import load_dataset


@pytest.fixture
def one_torch_thread():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same(a, b):
    for f in ("train_x", "train_y", "train_mask", "train_counts", "test_x", "test_y",
              "test_mask"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.class_num, a.task, a.name) == (b.class_num, b.task, b.name)


def _both(name, **kw):
    return load_dataset(name, **kw), jax_data.load_dataset(name, **kw)


def _so_corpus(d):
    import h5py

    words = ["the", "cat", "sat", "on", "mat", "dog", "ran", "far"]
    with open(f"{d}/stackoverflow.word_count", "w") as f:
        for i, w in enumerate(words):
            f.write(f"{w} {100 - i}\n")
    with open(f"{d}/stackoverflow.tag_count", "w") as f:
        json.dump({"python": 50, "jax": 40, "tpu": 30}, f)
    for fname in ("stackoverflow_train.h5", "stackoverflow_test.h5"):
        with h5py.File(f"{d}/{fname}", "w") as f:
            for cid in ("alice", "bob", "carol"):
                g = f.create_group(f"examples/{cid}")
                g.create_dataset("tokens", data=[b"the cat sat", b"dog ran far zzz",
                                                 b" ".join([b"the"] * 25)])
                g.create_dataset("title", data=[b"on mat", b"the dog", b""])
                g.create_dataset("tags", data=[b"python|jax", b"tpu|unknown", b"jax"])
    return words


@pytest.mark.parametrize("name", ["stackoverflow_lr", "stackoverflow_nwp"])
def test_stackoverflow_h5_paths_match_jax(tmp_path, name):
    words = _so_corpus(tmp_path)
    got, want = _both(name, data_dir=str(tmp_path), client_num_in_total=2, batch_size=2)
    _same(got, want)
    assert got.train_x.shape[0] == 2
    if name == "stackoverflow_lr":
        assert got.train_x.shape[-1] == len(words) and got.class_num == 3
        np.testing.assert_allclose(got.train_x[0, 1].sum(), 5.0 / 6.0, atol=1e-6)
    else:
        assert got.class_num == len(words) + 4 and got.train_x.shape[-1] == 20


@pytest.mark.parametrize("name,kw", [("stackoverflow_lr", {"client_num_in_total": 6}),
                                     ("stackoverflow_nwp", {"client_num_in_total": 6}),
                                     ("stackoverflow_lr", {"client_num_in_total": 5000})])
def test_stackoverflow_stand_ins_match_jax(tmp_path, name, kw):
    got, want = _both(name, data_dir=str(tmp_path / "absent"), batch_size=4, seed=3, **kw)
    if kw["client_num_in_total"] > 4096:     # the cross-device dataset
        assert got.num_clients == want.num_clients == 5000
        np.testing.assert_array_equal(got.train_counts, want.train_counts)
        return
    _same(got, want)
    assert got.train_x.shape[-1] == (10000 if name == "stackoverflow_lr" else 20)
    assert got.class_num == (500 if name == "stackoverflow_lr" else 10004)


@pytest.mark.parametrize("name", ["stackoverflow_lr", "stackoverflow_nwp"])
def test_stackoverflow_h5_without_tables_raises(tmp_path, name):
    _so_corpus(tmp_path)
    (tmp_path / "stackoverflow.word_count").unlink()
    with pytest.raises(FileNotFoundError, match="vocab tables"):
        load_dataset(name, data_dir=str(tmp_path))


def _image(path, rng, size=10):
    from PIL import Image

    Image.fromarray(rng.integers(0, 255, (size, size + 3, 3), dtype=np.uint8)).save(path)


def test_imagenet_folder_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for c in ("n01", "n02", "n03"):
        (tmp_path / "ILSVRC2012" / "train" / c).mkdir(parents=True)
        for i in range(7):
            _image(tmp_path / "ILSVRC2012" / "train" / c / f"{i}.JPEG", rng)
    for name in ("ILSVRC2012", "imagenet"):
        got, want = _both(name, data_dir=str(tmp_path), num_clients=3, batch_size=4,
                          image_size=8, max_per_class=5, seed=1)
        _same(got, want)
        assert got.class_num == 3 and got.train_x.shape[2:] == (8, 8, 3)


@pytest.mark.parametrize("variant", ["gld23k", "gld160k"])
def test_landmarks_csv_matches_jax(tmp_path, variant):
    rng = np.random.default_rng(1)
    (tmp_path / "landmarks" / "images").mkdir(parents=True)
    rows = ["user_id,image_id,class"]
    for u in range(3):
        for i in range(5):
            iid = f"u{u}i{i}"
            _image(tmp_path / "landmarks" / "images" / f"{iid}.jpg", rng)
            rows.append(f"user{u},{iid},{(u + i) % 4}")
    (tmp_path / "landmarks" / f"{variant}_train.csv").write_text("\n".join(rows) + "\n")
    got, want = _both(variant, data_dir=str(tmp_path), num_clients=2, batch_size=4,
                      image_size=8)
    _same(got, want)
    assert got.num_clients == 2 and got.name == variant


@pytest.mark.parametrize("name", ["ILSVRC2012", "imagenet", "gld23k", "gld160k"])
def test_image_stand_ins_match_jax(tmp_path, name):
    got, want = _both(name, data_dir=str(tmp_path), num_clients=3, batch_size=8,
                      image_size=12, seed=2)
    _same(got, want)
    assert got.train_x.shape[2:] == (12, 12, 3)


def test_hetero_fix_map_is_made_once_and_shared_with_jax(tmp_path):
    labels = np.random.default_rng(0).integers(0, 10, 300).astype(np.int32)
    path = str(tmp_path / "map.npz")
    made = tpart.partition("hetero-fix", labels, 6, 10, 0.5, seed=1, map_path=path)
    assert sorted(np.concatenate(list(made.values())).tolist()) == list(range(300))
    want = jpart.hetero_partition(labels, 6, 10, 0.5, seed=1)
    for i in range(6):
        np.testing.assert_array_equal(made[i], want[i])
    # read back, by both packages, whatever the seed or alpha now says
    for m in (tpart.partition("hetero-fix", labels, 6, 10, 0.9, seed=7, map_path=path),
              jpart.partition("hetero-fix", labels, 6, 10, 0.9, seed=7, map_path=path)):
        for i in range(6):
            np.testing.assert_array_equal(m[i], made[i])
    jpath = str(tmp_path / "jax.npz")
    jmade = jpart.partition("hetero-fix", labels, 6, 10, 0.3, seed=2, map_path=jpath)
    got = tpart.partition("hetero-fix", labels, 6, 10, 0.3, seed=2, map_path=jpath)
    for i in range(6):
        np.testing.assert_array_equal(got[i], jmade[i])


def test_hetero_fix_refuses_a_stale_map(tmp_path):
    labels = np.zeros(100, np.int32)
    path = str(tmp_path / "map.npz")
    tpart.partition("hetero-fix", labels, 4, 10, 0.5, map_path=path)
    with pytest.raises(ValueError, match="has 4 clients, expected 5"):
        tpart.partition("hetero-fix", labels, 5, 10, 0.5, map_path=path)
    with pytest.raises(ValueError, match="covers 100 records"):
        tpart.partition("hetero-fix", np.zeros(80, np.int32), 4, 10, 0.5, map_path=path)
    with pytest.raises(ValueError, match="map_path"):
        tpart.partition("hetero-fix", labels, 4, 10, 0.5)


def test_hetero_fix_through_the_loaders_matches_jax(tmp_path):
    kw = dict(partition_method="hetero-fix", partition_alpha=0.5, client_num_in_total=4,
              batch_size=8, seed=0)
    got = load_dataset("cifar10", data_dir=str(tmp_path / "t"), **kw)
    want = jax_data.load_dataset("cifar10", data_dir=str(tmp_path / "j"), **kw)
    _same(got, want)
    assert {p.name for p in (tmp_path / "t").iterdir()} == {p.name for p in
                                                           (tmp_path / "j").iterdir()}


@pytest.mark.parametrize("model,dataset", [("cnn_dropout", "femnist"),
                                           ("rnn_stackoverflow", "stackoverflow_nwp"),
                                           ("lr", "stackoverflow_lr"), ("rnn", "shakespeare")])
def test_the_launcher_runs_the_new_names(model, dataset, capsys, one_torch_thread):
    """``experiments.run.main`` dispatches the new model and dataset names as
    the JAX launcher does (``create_model`` of ``--model`` at the dataset's
    input shape, ``load_dataset`` of ``--dataset``); one round each."""
    from fedml_tpu_torch.experiments.run import main

    result = main(f"--algorithm fedavg --dataset {dataset} --model {model} "
                  "--client_num_in_total 4 --client_num_per_round 2 --comm_round 1 "
                  "--batch_size 8 --lr 0.05 --ci 1".split(), device="cpu")
    assert np.isfinite(result["Test/Loss"][-1]), result

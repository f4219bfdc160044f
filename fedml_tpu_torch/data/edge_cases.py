"""Edge-case backdoor datasets, poisoned federations (counterpart of
``fedml_tpu/data/edge_cases.py``; numpy, bit-equal to it).

Counterpart of reference fedml_api/data_preprocessing/edge_case_examples/
data_loader.py:283 ``load_poisoned_dataset``: attacker clients' training
data is augmented with "edge-case" examples — real-looking inputs from a
rare tail distribution relabeled to the attacker's target class (southwest
airliners -> 'truck' in CIFAR-10, ARDIS digits -> '7' in EMNIST) — plus a
backdoor test set to measure targeted success.

Real poison archives are file-gated (zero egress); the fallback synthesizes
an off-manifold edge cluster: inputs drawn far from every class mean,
labeled with the target class. This preserves the measurement the
reference's datasets exist for — clean accuracy vs targeted backdoor
accuracy — with no downloaded data.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass

import numpy as np

from fedml_tpu_torch.data import FedDataset


@dataclass
class PoisonedFederation:
    dataset: FedDataset            # train data with attacker clients poisoned
    attacker_clients: list         # indices of poisoned clients
    target_class: int
    edge_test_x: np.ndarray        # backdoor eval inputs
    edge_test_y: np.ndarray        # all == target_class
    edge_test_true_y: np.ndarray   # what they SHOULD be classified as


def _synthesize_edge_cases(
    base: FedDataset, n: int, target_class: int, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Off-manifold cluster: base-distribution shape, shifted far from the
    data mean with a fixed pattern so the backdoor is learnable."""
    shape = (n,) + tuple(base.train_x.shape[2:])
    x = rng.normal(0, 0.3, shape).astype(base.train_x.dtype)
    # fixed structured offset = the 'edge-case signature'
    sig = np.linspace(-1.5, 1.5, int(np.prod(shape[1:]))).reshape(shape[1:])
    x = x + sig.astype(x.dtype)
    # true labels deliberately exclude the attack target so targeted-accuracy
    # eval (robust.py backdoor metrics) measures real label flips
    y_true = rng.integers(0, max(base.class_num - 1, 1), n)
    y_true = np.where(y_true >= target_class, y_true + 1, y_true) \
        if base.class_num > 1 else y_true
    return x, y_true.astype(base.train_y.dtype)


# CIFAR-10 channel statistics the reference's transform pipeline applies to
# the raw uint8 southwest images (data_loader.py:330-339)
_CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
_CIFAR_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)

# archive filenames per attack case (reference data_loader.py:344-361)
_SOUTHWEST_FILES = {
    "edge-case": ("southwest_images_new_train.pkl",
                  "southwest_images_new_test.pkl"),
    "normal-case": ("southwest_images_adv_p_percent_edge_case.pkl",
                    "southwest_images_p_percent_edge_case_test.pkl"),
    "almost-edge-case": ("southwest_images_adv_p_percent_edge_case.pkl",
                         "southwest_images_p_percent_edge_case_test.pkl"),
}


def _load_southwest_archives(data_dir: str, attack_case: str, base: FedDataset):
    """Parse the reference's REAL southwest archives — raw [N, 32, 32, 3]
    uint8 ndarray pickles under edge_case_examples/southwest_cifar10/
    (data_loader.py:344-376; labels are implicit — every image is relabeled
    to the attack target, true class 'airplane'). Returns
    (train_x, test_x) in the base dataset's dtype/normalization, or None
    when the files are absent (zero-egress fallback)."""
    names = _SOUTHWEST_FILES.get(attack_case)
    if names is None:
        return None
    sw_dir = os.path.join(data_dir, "edge_case_examples", "southwest_cifar10")
    paths = [os.path.join(sw_dir, n) for n in names]
    if not all(os.path.exists(p) for p in paths):
        return None
    out = []
    for p in paths:
        with open(p, "rb") as f:
            arr = np.asarray(pickle.load(f))
        if arr.ndim != 4 or arr.shape[1:] != tuple(base.train_x.shape[2:]):
            raise ValueError(
                f"southwest archive {p}: expected raw images "
                f"[N, {base.train_x.shape[2:]}], got {arr.shape}")
        if arr.dtype == np.uint8:  # reference transform: ToTensor + Normalize
            arr = (arr.astype(np.float32) / 255.0 - _CIFAR_MEAN) / _CIFAR_STD
        out.append(arr.astype(base.train_x.dtype))
    return out[0], out[1]


def load_poisoned_dataset(
    base: FedDataset,
    attack_case: str = "edge-case",
    target_class: int = 1,
    attacker_clients: list | None = None,
    poison_frac: float = 0.5,
    data_dir: str = "./data",
    seed: int = 0,
) -> PoisonedFederation:
    """Inject edge-case poison into `attacker_clients` (default: client 1,
    like the reference's rank-1 attacker, FedAvgRobustTrainer.py:14-25).

    With real archives the genuine edge images are used — the reference's
    southwest layout ({data_dir}/edge_case_examples/southwest_cifar10/
    southwest_images_new_{train,test}.pkl, raw uint8 image stacks) or the
    generic {attack_case}.pkl dict {"x", "y_true"} — otherwise the synthetic
    edge cluster. ``poison_frac`` of each attacker's real records are
    replaced.
    """
    rng = np.random.default_rng(seed)
    attacker_clients = attacker_clients if attacker_clients is not None else [1]
    path = os.path.join(data_dir, "edge_case_examples", f"{attack_case.replace('-', '_')}.pkl")
    n_pad = base.train_x.shape[1]
    # pool-sizing estimate for the synthetic fallback (upper bound); the
    # ACTUAL per-attacker poison count is poison_frac of that attacker's
    # REAL record count, computed in the injection loop below.
    # poison_frac=0 must mean a genuinely clean control federation
    n_poison_per = max(int(n_pad * poison_frac), 1) if poison_frac > 0 else 0

    southwest = _load_southwest_archives(data_dir, attack_case, base)
    edge_test_from_archive = None
    if southwest is not None:
        edge_x, edge_test_from_archive = southwest
        # southwest true class is 'airplane' (reference relabels 0 -> 9)
        edge_true = np.zeros(len(edge_x), base.train_y.dtype)
    elif os.path.exists(path):
        with open(path, "rb") as f:
            blob = pickle.load(f)
        edge_x = np.asarray(blob["x"], base.train_x.dtype)
        edge_true = np.asarray(blob.get("y_true", np.zeros(len(edge_x))), base.train_y.dtype)
    else:
        edge_x, edge_true = _synthesize_edge_cases(
            base, n_poison_per * (len(attacker_clients) + 4), target_class, rng
        )

    train_x = base.train_x.copy()
    train_y = base.train_y.copy()
    used = 0
    for c in attacker_clients:
        # poison REPLACES real records (slots within the client's true
        # count), preserving the mask/count invariant the local trainer
        # relies on — padded slots never train, so flipping their mask
        # would silently shrink the effective poison
        n_real = int(base.train_counts[c])
        n_poison = max(int(n_real * poison_frac), 1) if poison_frac > 0 else 0
        take = min(n_poison, len(edge_x) - used, n_real)
        slots = rng.choice(n_real, take, replace=False)
        train_x[c, slots] = edge_x[used : used + take]
        train_y[c, slots] = target_class
        used += take

    # backdoor test set: the archive's dedicated test images (reference
    # keeps southwest_*_test.pkl as the targeted task test set) or the
    # leftover edge cases
    if edge_test_from_archive is not None:
        edge_test_x = edge_test_from_archive
        # same true class as the train archive (airplane=0, set where the
        # southwest branch builds edge_true)
        edge_test_true = np.full(len(edge_test_x), edge_true[0] if len(edge_true)
                                 else 0, base.train_y.dtype)
    else:
        edge_test_x = edge_x[used:]
        edge_test_true = edge_true[used:]
    import dataclasses

    poisoned = dataclasses.replace(
        base, train_x=train_x, train_y=train_y,
        name=f"{base.name}+{attack_case}",
    )
    return PoisonedFederation(
        dataset=poisoned,
        attacker_clients=list(attacker_clients),
        target_class=target_class,
        edge_test_x=edge_test_x,
        edge_test_y=np.full(len(edge_test_x), target_class, base.train_y.dtype),
        edge_test_true_y=edge_test_true,
    )


def backdoor_success_rate(logits: np.ndarray, target_class: int) -> float:
    """Fraction of edge-case inputs classified as the attacker's target."""
    if len(logits) == 0:
        return 0.0
    return float((np.argmax(logits, axis=-1) == target_class).mean())

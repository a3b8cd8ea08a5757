"""The port's checkpoint store (``checkpoint/store.py``), the bridge's
inverse (``bridge.reference_tree``), the training launcher
(``launch/train.py``) and the kernel wrappers' refusal of autograd,
held against the reference on the CPU: a round trip of bfloat16 and of
structure, ``checkpoint_manifest``, the two stores reading each other's
model files array for array (a RecurrentGemma stack with a tail and a
Whisper encoder included), the reference's checkpoint-retry case
(``tests/test_robustness.py``), and the launcher's checkpoint read back
by the reference.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jax_store
from repro.configs import get_smoke as jax_get_smoke
from repro.core.lora import partition_lora as jax_partition_lora
from repro.models import transformer as jax_tf
from repro.models.config import LoRAConfig as JLoRAConfig
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.checkpoint import store
from repro_torch.checkpoint.bridge import (load_params, params_from_flat,
                                          reference_tree)
from repro_torch.configs import get_smoke
from repro_torch.core.lora import partition_lora, tree_leaves
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.launch import train as launch_train
from repro_torch.models.config import LoRAConfig, ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.serving.faults import (ArtifactFault, ArtifactLoadError,
                                        FaultPlan)

# the reference's tests/test_checkpoint.py CFG (bfloat16)
CFG_J = JModelConfig(name="tiny", family="dense", num_layers=2, d_model=32,
                     num_heads=2, num_kv_heads=1, d_ff=64, vocab_size=64,
                     lora=JLoRAConfig(rank=4, alpha=8.0))
CFG = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=32,
                  num_heads=2, num_kv_heads=1, d_ff=64, vocab_size=64,
                  lora=LoRAConfig(rank=4, alpha=8.0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _files(path: str):
    with open(path + ".json") as f:
        info = json.load(f)
    with np.load(path + ".npz") as z:
        return {k: z[k] for k in z.files}, info


# ------------------------------------------------------------- round trip
def test_roundtrip_bf16_and_structure(tmp_path):
    gen = torch.Generator()
    gen.manual_seed(0)
    tree = {"w": torch.randn(3, 4, generator=gen).to(torch.bfloat16),
            "f": torch.randn(5, generator=gen),
            "t": (torch.arange(3, dtype=torch.int32),
                  {"x": torch.ones(2, dtype=torch.bfloat16)}),
            "l": [torch.zeros(1), torch.ones(2)],
            "e": (), "n": None, "d": {"m": None}}
    path = str(tmp_path / "ck")
    assert store.save_checkpoint(path, tree, {"cfg": "x"}) > 0
    got, meta = store.load_checkpoint(path, device="cpu")
    assert meta == {"cfg": "x"}
    assert set(got) == {"w", "f", "t", "l", "e"}     # None leaves dropped
    assert got["e"] == () and isinstance(got["t"], tuple)
    assert isinstance(got["l"], tuple) and len(got["l"]) == 2
    for a, b in ((tree["w"], got["w"]), (tree["f"], got["f"]),
                 (tree["t"][0], got["t"][0]),
                 (tree["t"][1]["x"], got["t"][1]["x"]),
                 (tree["l"][1], got["l"][1])):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))
    # the reference reads the same file into the same values
    ref, meta_j = jax_store.load_checkpoint(path)
    assert meta_j == meta and ref["w"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(ref["w"]).view(np.int16),
                          _bits(got["w"]))


def test_port_model_roundtrips_as_the_reference_test_does(tmp_path):
    """The reference's ``test_roundtrip_bf16_and_structure`` on the port's
    own bfloat16 params (one adapter): every leaf back bit for bit."""
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tf.init_params(CFG, gen, "cpu", lora_adapters=None)
    path = os.path.join(tmp_path, "ckpt")
    assert store.save_checkpoint(path, params, {"cfg": CFG.name}) > 0
    loaded, meta = store.load_checkpoint(path, device="cpu")
    assert meta["cfg"] == CFG.name
    la, lb = tree_leaves(params), tree_leaves(loaded)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_manifest_matches_reference_and_partition():
    flat = jax_store._flatten(jax_tf.init_params(jax.random.PRNGKey(0),
                                                 CFG_J))
    params_j = jax_store._unflatten(flat)
    params_t = params_from_flat(flat, CFG, device="cpu")
    man = store.checkpoint_manifest(params_t)
    assert man == jax_store.checkpoint_manifest(params_j)
    bb, ad = partition_lora(params_t)
    nb = sum(x.numel() * x.element_size() for x in tree_leaves(bb))
    na = sum(x.numel() * x.element_size() for x in tree_leaves(ad))
    assert man == {"backbone_bytes": nb, "adapter_bytes": na,
                   "total_bytes": nb + na}
    assert man["adapter_bytes"] < 0.2 * man["backbone_bytes"]


# ------------------------------------------- the two stores, model files
@pytest.mark.parametrize("arch,layers", [("llama2_7b", None),
                                         ("recurrentgemma_9b", 5),
                                         ("whisper_medium", None),
                                         ("mixtral_8x22b", None)])
def test_model_files_cross_between_the_stores(arch, layers, tmp_path):
    """The reference saves a model (bfloat16, one adapter; RecurrentGemma at
    5 layers: one period of 3 and a tail of 2); the port loads it through
    the bridge, stacks it back with ``reference_tree`` and saves it: the
    same arrays bit for bit and the same dtype tags.  The reference's
    ``load_checkpoint`` then reads the port's file into its own tree."""
    kw = {} if layers is None else {"num_layers": layers}
    cfg_j = jax_get_smoke(arch).with_(**kw)
    cfg_t = get_smoke(arch).with_(**kw)
    params_j = jax_tf.init_params(jax.random.PRNGKey(1), cfg_j)
    ref_path, port_path = str(tmp_path / "ref"), str(tmp_path / "port")
    jax_store.save_checkpoint(ref_path, params_j, {"arch": arch})
    params_t = load_params(ref_path, cfg_t, device="cpu")
    assert store.save_checkpoint(port_path, reference_tree(params_t, cfg_t),
                                 {"arch": arch}) > 0
    (a, info_a), (b, info_b) = _files(ref_path), _files(port_path)
    assert a.keys() == b.keys() and info_a == info_b
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    back, meta = jax_store.load_checkpoint(port_path)
    assert meta == {"arch": arch}
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params_j)
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params_j)):
        assert x.dtype == y.dtype and np.array_equal(
            np.asarray(x, np.float32), np.asarray(y, np.float32))
    # and the port's own store reads the reference's file leaf for leaf
    flat_t = store._flatten(store.load_checkpoint(ref_path,
                                                  device="cpu")[0])
    flat_j = jax_store._flatten(params_j)
    assert flat_t.keys() == flat_j.keys()
    assert store.checkpoint_manifest(params_t) == \
        jax_store.checkpoint_manifest(params_j)


# ------------------------------------------------------------ retries
def test_checkpoint_load_retries_through_fault_hook(tmp_path):
    """The reference's ``test_robustness.py::
    test_checkpoint_load_retries_through_fault_hook`` on the port's store:
    one injected fault retried, five exhaust the retries."""
    path = str(tmp_path / "ckpt")
    store.save_checkpoint(path, {"w": np.arange(4, dtype=np.float32)},
                          meta={"k": 1})
    plan = FaultPlan(artifact_faults=[ArtifactFault("checkpoint", fails=1)])
    loaded, meta = store.load_checkpoint(path, retries=1,
                                         fault_hook=plan.artifact_check,
                                         device="cpu")
    assert meta == {"k": 1}
    np.testing.assert_array_equal(loaded["w"].numpy(),
                                  np.arange(4, dtype=np.float32))
    assert plan.artifact_faults[0].injected == 1
    plan2 = FaultPlan(artifact_faults=[ArtifactFault("checkpoint",
                                                     fails=5)])
    with pytest.raises(ArtifactLoadError):
        store.load_checkpoint(path, retries=1,
                              fault_hook=plan2.artifact_check, device="cpu")


# ----------------------------------------------------------- the launcher
def test_launcher_trains_and_its_checkpoint_is_read_by_the_reference(
        tmp_path, capsys):
    path = str(tmp_path / "trained")
    run = launch_train.main(["--device", "cpu", "--arch", "llama2_7b",
                             "--steps", "4", "--batch", "2", "--seq", "16",
                             "--ckpt", path])
    out = capsys.readouterr().out
    assert len(run.losses) == 4 and all(np.isfinite(run.losses))
    assert "loss:" in out and "backbone_bytes" in out
    # B starts at 0 (the reference's init) and moves
    _, ad = partition_lora(run.adapters)
    assert any(float(x.abs().max()) > 0 for x in tree_leaves(ad))
    cfg_j = jax_get_smoke("llama2_7b")
    params_j, meta = jax_store.load_checkpoint(path)
    assert meta == {"arch": "llama2_7b"}
    assert jax.tree_util.tree_structure(params_j) == \
        jax.tree_util.tree_structure(jax_tf.init_params(
            jax.random.PRNGKey(0), cfg_j))
    _, ad_j = jax_partition_lora(params_j)
    assert all(x.ndim == 3 for x in jax.tree_util.tree_leaves(ad_j))
    toks = jnp.asarray(np.arange(10, dtype=np.int32)[None] % 512)
    logits, _, _ = jax_tf.forward(params_j, cfg_j, toks)
    assert bool(jnp.all(jnp.isfinite(logits.astype(jnp.float32))))


@pytest.mark.parametrize("arch", ["paligemma_3b", "whisper_medium"])
def test_launcher_feeds_zero_extras(arch, capsys):
    run = launch_train.main(["--device", "cpu", "--arch", arch, "--steps",
                             "2", "--batch", "2", "--seq", "8"])
    assert all(np.isfinite(run.losses))


def test_launcher_refuses_mesh():
    """A --mesh whose size is not the world's is refused; without torchrun
    the world is one rank, joined for the check and left again."""
    import torch.distributed as dist
    with pytest.raises(ValueError, match="4 ranks for a world of 1"):
        launch_train.main(["--device", "cpu", "--mesh", "2x2",
                           "--steps", "1"])
    assert not dist.is_initialized()


# ----------------------------------------------- the kernels refuse autograd
def test_refuse_autograd_only_while_grad_is_on():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        cuda_lib.refuse_autograd("k", torch.ones(2), x)
    cuda_lib.refuse_autograd("k", torch.ones(2), x.detach())
    with torch.no_grad():
        cuda_lib.refuse_autograd("k", x)


def test_plain_versions_still_carry_gradients_on_the_cpu():
    """Only a CUDA input is refused: on the CPU a wrapper runs its plain
    version, which carries the gradient."""
    q = torch.randn(1, 4, 2, 32, requires_grad=True)
    k = torch.randn(1, 4, 2, 32)
    flash_mha(q, k, k).sum().backward()
    assert q.grad is not None and float(q.grad.abs().max()) > 0

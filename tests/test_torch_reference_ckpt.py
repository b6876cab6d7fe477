"""Port parity: reference ``.pt`` checkpoints (deepaco_tpu_torch/models/
torch_compat.py, models/transformer.py's mapping, the CLI's ``--ckpt *.pt``
and its ``$DEEPACO_REFERENCE_ROOT`` default) and ``utils/checkpoint.
save_params_npz`` against the JAX package. The repository holds no
reference ``.pt`` file, so each test writes reference-layout state dicts
with ``torch.save`` from the committed msgpack weights, through the writer
``chip_smoke.py`` uses: BatchNorm entries under ``.module.`` with
``num_batches_tracked``, the transformer's under the reference's names."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from deepaco_tpu import families as jfamilies
from deepaco_tpu.models import torch_compat as jcompat
from deepaco_tpu.models import transformer as jtransformer
from deepaco_tpu.models.gnn import Net as JNet
from deepaco_tpu.train import drivers as jdrivers
from deepaco_tpu.utils import checkpoint as jcheckpoint
from deepaco_tpu_torch import cli, families
from deepaco_tpu_torch.core.rcpsp import parse_rcp, progen_rcp, stack_rcpsp
from deepaco_tpu_torch.eval.rcpsp import rcpsp_heuristics, rcpsp_net
from deepaco_tpu_torch.models import torch_compat, transformer
from deepaco_tpu_torch.models.gnn import Net, to_jax_variables
from deepaco_tpu_torch.train import drivers
from deepaco_tpu_torch.train.reinforce import tsp_heuristic
from deepaco_tpu_torch.utils.checkpoint import load_checkpoint, save_params_npz
from deepaco_tpu_torch.utils.datasets import uniform_coords


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs: the tier-1
    command runs six pytest workers at once, and an OpenMP pool as wide as
    the host in each of them oversubscribes its cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


ROOT = Path(__file__).resolve().parent.parent


def _tree(name):
    t = load_checkpoint(str(ROOT / "checkpoints" / f"{name}_selftrained.msgpack"))
    return {k: t[k] for k in ("params", "batch_stats") if t.get(k)}


def _write_pt(tmp_path, tree, name="ref.pt"):
    """``tree`` loaded into the port's model it sizes, then saved under the
    reference's names by ``chip_smoke.reference_state_dict``."""
    net = (transformer.TransformerModel.from_jax_variables(tree) if "encoder" in tree["params"]
           else Net.from_jax_variables(tree))
    path = tmp_path / name
    torch.save(chip_smoke.reference_state_dict(net), path)
    return path


def _assert_trees_equal(got, want, where=""):
    assert isinstance(got, dict) and isinstance(want, dict), where
    assert set(got) == set(want), where
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{where}/{k}")
        else:
            assert got[k].dtype == np.asarray(want[k]).dtype, f"{where}/{k}"
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{where}/{k}")


def _family_heuristic(name, net):
    """The family's eval-mode heuristic on two seeded instances of 12 nodes."""
    fam = families.get_family(name)
    batch = drivers.gen_batch(fam, np.random.default_rng(0), 12, 2)
    return drivers._forward_heu(fam, net, fam.prepare(drivers.instance_tensors(batch, "cpu")), 4)


def _heuristic(case, net):
    with torch.no_grad():
        if case == "tsp_nls100":
            coords = uniform_coords(12, torch.Generator().manual_seed(0), batch=2)
            return tsp_heuristic(net, coords, k_sparse=4, eps=1e-10, train=False,
                                 nls_graph=True)[0]
        if case == "rcpsp30":
            rng = np.random.default_rng(0)
            return rcpsp_heuristics(stack_rcpsp([parse_rcp(progen_rcp(rng, jobs=10))
                                                 for _ in range(2)]), net)
        return _family_heuristic(case.rstrip("0123456789"), net)


def _command_net(case, tree):
    """The net the command that reads ``case``'s checkpoint builds."""
    if case == "tsp_nls100":
        return Net.from_jax_variables(tree, dual_heads=False)
    if case == "rcpsp30":
        return rcpsp_net(tree)
    return drivers.family_model(families.get_family(case.rstrip("0123456789")), tree)


CASES = ["tsp20", "tsp_nls100", "cvrp20", "smtwtp50", "rcpsp30", "mkp_items300"]


@pytest.mark.parametrize("case", CASES)
def test_reference_pt_reads_into_jax_trees_and_the_msgpack_heuristics(case, tmp_path):
    """A reference-layout ``.pt`` of each committed checkpoint: the port's
    ``load_reference_checkpoint`` gives JAX's tree to the bit (dtype and
    values), and the command's net built from it gives the heuristic of
    the net built from the msgpack, to the bit."""
    tree = _tree(case)
    path = _write_pt(tmp_path, tree)
    got = torch_compat.load_reference_checkpoint(str(path))
    _assert_trees_equal(got, jcompat.load_reference_checkpoint(str(path)))
    _assert_trees_equal(got, tree)
    a, b = _command_net(case, got), _command_net(case, tree)
    if case == "mkp_items300":
        src = torch.from_numpy(np.random.default_rng(0).random((2, 12, 6), dtype=np.float32))
        with torch.no_grad():
            assert torch.equal(a(src), b(src))
    else:
        assert torch.equal(_heuristic(case, a), _heuristic(case, b))


def test_transformer_loader_equals_jax(tmp_path):
    path = _write_pt(tmp_path, _tree("mkp_items300"))
    got = transformer.load_transformer_checkpoint(str(path))
    _assert_trees_equal(got, jtransformer.load_transformer_checkpoint(str(path)))
    net = transformer.TransformerModel.from_jax_variables(got)
    assert len(net.layers) == 3 and net.encoder.in_features == 6


@pytest.mark.parametrize("case", ["cvrp20_phe_head", "smtwtp50_node_bns"])
def test_entries_the_family_net_does_not_read_are_ignored_as_in_jax(case, tmp_path):
    """CVRP20's weights with a pheromone head, and SMTWTP50's with node
    BatchNorms (copies of the edge ones), neither of which the family's net
    reads. Each package ignores them: its family net's heuristic from the
    ``.pt`` equals, to the bit, the one from the clean tree. The port's
    gives JAX's at rtol 1e-5, with atol 2e-6 for the smallest entries
    (the two packages sum 12 layers in f32 in different orders, 1.8e-6 at
    most here)."""
    tree = _tree(case.split("_")[0])
    name = case.split("_")[0].rstrip("0123456789")
    extra = {"params": {**tree["params"], "emb_net": dict(tree["params"]["emb_net"])},
             "batch_stats": {"emb_net": dict(tree["batch_stats"]["emb_net"])}}
    if case.endswith("phe_head"):
        extra["params"]["par_net_phe"] = tree["params"]["par_net_heu"]
    else:
        for key in [k for k in tree["params"]["emb_net"] if k.startswith("e_bns_")]:
            i = key[6:]
            extra["params"]["emb_net"][f"v_bns_{i}"] = tree["params"]["emb_net"][key]
            extra["batch_stats"]["emb_net"][f"v_bns_{i}"] = tree["batch_stats"]["emb_net"][key]
    path = _write_pt(tmp_path, extra)
    jtree = jcompat.load_reference_checkpoint(str(path))
    assert ("par_net_phe" in jtree["params"]) or ("v_bns_0" in jtree["params"]["emb_net"])
    fam = families.get_family(name)
    net = drivers.family_model(fam, torch_compat.load_reference_checkpoint(str(path)))
    assert not net.dual_heads
    with torch.no_grad():
        got = _family_heuristic(name, net)
        assert torch.equal(got, _family_heuristic(name, drivers.family_model(fam, tree)))
    batch = drivers.gen_batch(fam, np.random.default_rng(0), 12, 2)
    jfam = jfamilies.get_family(name)
    model = JNet(**dict(jfam.model_kwargs))

    def jax_heuristic(variables):
        return np.stack([np.asarray(jdrivers._forward_heu(
            jfam, model, variables["params"], variables["batch_stats"],
            jfam.prepare({k: jnp.asarray(v[i]) for k, v in batch.items()}), 4, False)[0])
            for i in range(2)])

    want = jax_heuristic(jtree)
    np.testing.assert_array_equal(want, jax_heuristic(tree))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-6)


def test_an_entry_no_net_reads_still_raises():
    """Only the unread pheromone head is ignored: a tree with an extra
    ``emb_net`` layer does not fit the family's net and raises."""
    tree = _tree("cvrp20")
    emb = {**tree["params"]["emb_net"], "v_lin9": tree["params"]["emb_net"]["v_lin0"]}
    extra = {**tree, "params": {**tree["params"], "emb_net": emb}}
    with pytest.raises(RuntimeError, match="unexpected"):
        drivers.family_model(families.get_family("cvrp"), extra)


@pytest.mark.parametrize("sd", [{"foo.bar": torch.zeros(1)},
                                {"emb_net.v_lin9.weight": torch.zeros(1)},
                                {"emb_net.v_bns.0.weight": torch.zeros(1)},
                                {"transformer_encoder.layers.0.self_attn.bias_k": torch.zeros(1)},
                                {"transformer_encoder.layers.0.norm3.weight": torch.zeros(1)}],
                         ids=["unknown", "emb_net", "bn-without-module", "attn", "norm3"])
def test_an_unknown_key_raises_value_error_as_in_jax(sd, tmp_path):
    path = tmp_path / "bad.pt"
    torch.save(sd, path)
    for load in (torch_compat.load_reference_checkpoint, jcompat.load_reference_checkpoint):
        with pytest.raises(ValueError, match="unrecognized"):
            load(str(path))


def _cli_means(capsys, argv):
    means, _ = cli.main(argv, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    return means, lines[1:-1], json.loads(lines[-1])["means"]


def test_cli_pt_checkpoint_prints_what_the_msgpack_prints(tmp_path, capsys, monkeypatch):
    """``test cvrp -n 20 --ckpt x.pt`` (with an extra head) and ``--ckpt
    x.msgpack`` of the same weights print the same cost lines, to the
    digit; so do ``test mkp_items -n 300``'s."""
    monkeypatch.chdir(ROOT)
    for name, n in (("cvrp20", "20"), ("mkp_items300", "300")):
        tree = _tree(name)
        if name == "cvrp20":
            tree = {**tree, "params": {**tree["params"],
                                       "par_net_phe": tree["params"]["par_net_heu"]}}
        pt = _write_pt(tmp_path, tree, f"{name}.pt")
        argv = ["test", name.rstrip("0123456789"), "-n", n, "--limit", "2", "-a", "4",
                "-t", "1", "2", "--ckpt"]
        got = _cli_means(capsys, argv + [str(pt)])
        want = _cli_means(capsys, argv + [f"checkpoints/{name}_selftrained.msgpack"])
        assert got[1] == want[1] and got[2] == want[2]
        np.testing.assert_array_equal(got[0], want[0])


def test_reference_root_default_is_taken_when_the_file_exists(tmp_path, capsys, monkeypatch):
    """Without ``--ckpt``, ``test cvrp -n 20`` takes
    ``$DEEPACO_REFERENCE_ROOT/pretrained/cvrp/cvrp20.pt`` when it exists
    (here CVRP100's weights, so the run is told apart from CVRP20's), and
    passes over it to the committed default when it does not; without the
    variable only the committed default is looked at."""
    monkeypatch.chdir(ROOT)
    argv = ["test", "cvrp", "-n", "20", "--limit", "2", "-a", "4", "-t", "1"]
    monkeypatch.delenv("DEEPACO_REFERENCE_ROOT", raising=False)
    with pytest.raises(SystemExit, match=r"looked at \['checkpoints/cvrp20\.msgpack'\]"):
        cli.main(argv, device="cpu")
    monkeypatch.setenv("DEEPACO_REFERENCE_ROOT", str(tmp_path))
    with pytest.raises(SystemExit, match=r"pretrained/cvrp/cvrp20\.pt', 'checkpoints/cvrp20"):
        cli.main(argv, device="cpu")
    (tmp_path / "pretrained" / "cvrp").mkdir(parents=True)
    _write_pt(tmp_path / "pretrained" / "cvrp", _tree("cvrp100"), "cvrp20.pt")
    got = _cli_means(capsys, argv)
    want = _cli_means(capsys, argv + ["--ckpt", "checkpoints/cvrp100_selftrained.msgpack"])
    other = _cli_means(capsys, argv + ["--ckpt", "checkpoints/cvrp20_selftrained.msgpack"])
    assert got[2] == want[2] != other[2]


def test_an_unreadable_pt_exits_naming_the_file_and_the_error(tmp_path):
    bad = tmp_path / "bad.pt"
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(SystemExit, match=r"cannot read checkpoint .*bad\.pt: ") as info:
        cli.main(["test", "cvrp", "-n", "20", "--limit", "1", "--ckpt", str(bad)],
                 device="cpu")
    assert info.value.__cause__ is not None


@pytest.mark.parametrize("name", ["cvrp20", "tsp20"])
def test_save_params_npz_matches_jax(name, tmp_path):
    """``save_params_npz`` of the loaded net's ``to_jax_variables`` params
    writes JAX's names and arrays for the same tree."""
    tree = _tree(name)
    net = drivers.family_model(families.get_family(name.rstrip("0123456789")), tree)
    save_params_npz(str(tmp_path / "port.npz"), to_jax_variables(net)["params"])
    jcheckpoint.save_params_npz(str(tmp_path / "jax.npz"), tree["params"])
    with np.load(tmp_path / "port.npz") as got, np.load(tmp_path / "jax.npz") as want:
        assert set(got.files) == set(want.files) and "emb_net/v_lins1_0/kernel" in got.files
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)

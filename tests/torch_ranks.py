"""Rank-side code of the port's multi-rank CPU tests (torch + the port only).

A test writes its inputs to ``<dir>/in.npz`` (arrays; flax parameter
trees flattened as ``"<tree>/a/b"``) and ``<dir>/in.json``, then
:func:`run_world` starts ``world`` processes of this file, each one a
rank of a gloo world joined through ``init_multihost`` with a file-store
address (``STPDE_COORDINATOR=file://<dir>/store``: no port, so parallel
test workers cannot collide). Each rank runs ``TARGETS[name]`` and
writes ``<dir>/out_<rank>.npz``; the test compares those with JAX in its
own process. Ranks run one thread each.
"""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(name: str, world: int, workdir: str, timeout: int = 240,
              inputs=None, spec=None, extra_env=None):
    """Run target ``name`` on ``world`` ranks; returns the ranks' outputs
    (a list of dicts of arrays). Raises with the ranks' output tails when
    a rank fails or the world outlives ``timeout`` seconds."""
    os.makedirs(workdir, exist_ok=True)
    np.savez(os.path.join(workdir, "in.npz"), **(inputs or {}))
    with open(os.path.join(workdir, "in.json"), "w") as f:
        json.dump(spec or {}, f)
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   STPDE_COORDINATOR=f"file://{workdir}/store",
                   STPDE_NUM_PROCESSES=str(world),
                   STPDE_PROCESS_ID=str(rank), **(extra_env or {}))
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            env.pop(k, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), name,
             workdir], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(f"rank {r}:\n{outs[r][-3000:]}"
                                     for r in failed))
    results = []
    for rank in range(world):
        with np.load(os.path.join(workdir, f"out_{rank}.npz")) as z:
            results.append({k: z[k] for k in z.files})
        results[-1]["_log"] = outs[rank]
    return results


# ---------------------------------------------------------------- helpers


def _inputs(workdir):
    with np.load(os.path.join(workdir, "in.npz"), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(workdir, "in.json")) as f:
        spec = json.load(f)
    return arrays, spec


def _tree(arrays, prefix):
    from space_time_pde_torch.bridge import unflatten_tree

    n = len(prefix) + 1
    return unflatten_tree({k[n:]: v for k, v in arrays.items()
                           if k.startswith(prefix + "/")})


def _t(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def _imnet(arrays, prefix, dim, lat, nf, out=4):
    from space_time_pde_torch.bridge import load_flax_params
    from space_time_pde_torch.models import ImNet

    return load_flax_params(ImNet(dim=dim, in_features=lat, out_features=out,
                                  nf=nf), _tree(arrays, prefix))


def _grads(state):
    return {f"grad/{k}": p.grad.detach().numpy().copy()
            for k, p in state.params().items()}


def _x_shard(a, mesh, axis):
    n = a.shape[axis] // mesh.n_space
    return np.take(a, np.arange(mesh.space_index * n,
                                (mesh.space_index + 1) * n), axis=axis)


# ---------------------------------------------------------------- targets


def target_halo(rank, world, arrays, spec):
    """halo.py and halo_conv.py on a 4-rank space group."""
    import torch

    from space_time_pde_torch.parallel.dp import make_mesh
    from space_time_pde_torch.parallel.halo import (
        halo_exchange, sharded_query_jet, sharded_query_local_implicit_grid)
    from space_time_pde_torch.parallel.halo_conv import (
        HaloConv3d, ShardedGroupNorm, halo_exchange_x)

    mesh = make_mesh(1, world)
    s = mesh.space_index
    out = {}
    imnet = _imnet(arrays, "imnet", 3, spec["C"], 2)
    lat = _t(_x_shard(arrays["latent"], mesh, 3))
    x_nodes = arrays["latent"].shape[3]
    pts = _t(arrays["binned"][s][None])
    with torch.no_grad():
        out["query"] = sharded_query_local_implicit_grid(
            imnet, lat, pts, mesh, x_nodes)[0].numpy()
        lat2 = _t(_x_shard(arrays["latent2"], mesh, 3))
        out["boundary"] = sharded_query_local_implicit_grid(
            lambda v: v[..., 3:7], lat2, _t(arrays["binned2"][s][None]),
            mesh, x_nodes)[0].numpy()
        ramp = _t(_x_shard(arrays["ramp"], mesh, 3))
        out["halo"] = halo_exchange(ramp, mesh).numpy()
        out["halo_x"] = halo_exchange_x(ramp, mesh, 1, 1).numpy()
    # The jet on [B, M, 3] points of this rank, forward and backward.
    jlat = _t(_x_shard(arrays["jet_latent"], mesh, 3)).requires_grad_(True)
    jpts = _t(arrays["jet_pts"][:, s])
    cot = [_t(arrays[f"jet_cot{i}"][:, s]) for i in range(3)]
    for fused in (True, False):
        jlat.grad = None
        for p in imnet.parameters():
            p.grad = None
        jet = sharded_query_jet(imnet, jlat, jpts, mesh, x_nodes,
                                fused=fused)
        tag = "fused" if fused else "plain"
        for i, j in enumerate(jet):
            out[f"jet_{tag}_{i}"] = j.detach().numpy()
        sum((j * c).sum() for j, c in zip(jet, cot)).backward()
        out[f"jet_{tag}_dlatent"] = jlat.grad.numpy().copy()
        for k, p in imnet.named_parameters():
            out[f"jet_{tag}_d/{k}"] = p.grad.numpy().copy()
    # HaloConv3d at stride 1 and 2, ShardedGroupNorm (channels-first).
    xc = _t(_x_shard(arrays["conv_x"], mesh, 3)).permute(0, 4, 1, 2, 3)
    for stride in (1, 2):
        conv = HaloConv3d(3, 5, 3, (1, 1, stride), mesh=mesh)
        with torch.no_grad():
            conv.weight.copy_(_t(np.moveaxis(
                arrays[f"conv{stride}/kernel"], (-1, -2), (0, 1))))
            conv.bias.copy_(_t(arrays[f"conv{stride}/bias"]))
            out[f"conv{stride}"] = conv(xc).permute(0, 2, 3, 4, 1).numpy()
    gn = ShardedGroupNorm(4, 8, mesh)
    with torch.no_grad():
        gn.weight.copy_(_t(arrays["gn/scale"]))
        gn.bias.copy_(_t(arrays["gn/bias"]))
        xg = _t(_x_shard(arrays["gn_x"], mesh, 3)).permute(0, 4, 1, 2, 3)
        out["gn"] = gn(xg).permute(0, 2, 3, 4, 1).numpy()
    return out


def target_sharded_unet(rank, world, arrays, spec):
    """ShardedUNet3d / ShardedUNet4d on a 4-rank space group: forward,
    backward (parameter gradients of a seeded cotangent, this rank's
    share) and BatchNorm's train mode."""
    import torch

    from space_time_pde_torch.bridge import load_flax_params
    from space_time_pde_torch.models import UNet3d, UNet4d
    from space_time_pde_torch.parallel.dp import make_mesh
    from space_time_pde_torch.parallel.sharded_unet import ShardedUNet3d
    from space_time_pde_torch.parallel.sharded_unet4d import ShardedUNet4d

    mesh = make_mesh(1, world)
    out = {}
    for tag, plain_cls, cls, igres, norm in (
            ("u3", UNet3d, ShardedUNet3d, spec["igres3"], "group"),
            ("bn", UNet3d, ShardedUNet3d, spec["igres3"], "batch"),
            ("u4", UNet4d, ShardedUNet4d, spec["igres4"], None)):
        kw = dict(in_features=4, out_features=8, igres=tuple(igres), nf=8)
        if norm:
            kw["norm"] = norm
        plain = plain_cls(**kw)
        stats = _tree(arrays, f"{tag}_stats") if norm == "batch" else None
        load_flax_params(plain, _tree(arrays, tag), stats)
        net = cls.from_plain(plain, mesh)
        ax = len(igres)
        x = _t(_x_shard(arrays[f"{tag}_x"], mesh, ax))
        cot = _t(_x_shard(arrays[f"{tag}_cot"], mesh, ax))
        net.train(norm == "batch")
        y = net(x)
        (y * cot).sum().backward()
        out[f"{tag}_y"] = y.detach().numpy()
        for k, p in net.named_parameters():
            out[f"{tag}_d/{k}"] = p.grad.numpy().copy()
        if norm == "batch":
            for k, b in net.named_buffers():
                if "running" in k:
                    out[f"{tag}_stat/{k}"] = b.numpy().copy()
    return out


def _rb2d_setup(spec, arrays, device="cpu"):
    """Models (unloaded) and PDE layer of the dp / dp_sp tests."""
    from space_time_pde_torch.physics import get_pde_layer
    from space_time_pde_torch.train import build_models
    from space_time_pde_torch.utils.config import Config

    cfg = Config.from_dict(spec["config"])
    unet, imnet = build_models(cfg, tuple(spec["lres_shape"]), device)
    pde = None
    if cfg.train.alpha_pde > 0:
        ext = spec["coord_extents"]
        kw = (dict(t_crop=ext[0], z_crop=ext[1], x_crop=ext[2],
                   rayleigh=spec["rayleigh"]) if len(ext) == 3 else
              dict(t_crop=ext[0], z_crop=ext[1], y_crop=ext[2],
                   x_crop=ext[3], viscosity=spec["viscosity"]))
        pde = get_pde_layer(cfg.physics.pde_system,
                            mean=arrays["channel_mean"],
                            std=arrays["channel_std"], **kw)
    return cfg, unet, imnet, pde


def _load(unet, imnet, arrays, prefix=""):
    """The flax trees ``<prefix>unet``, ``<prefix>imnet`` (and
    ``<prefix>stats`` for BatchNorm) into the models."""
    from space_time_pde_torch.bridge import load_flax_params

    stats = _tree(arrays, prefix + "stats") or None
    load_flax_params(unet, _tree(arrays, prefix + "unet"), stats)
    load_flax_params(imnet, _tree(arrays, prefix + "imnet"))


def target_dp(rank, world, arrays, spec):
    """parallel/dp.py on 2 data ranks: the data-parallel step, the
    multi-step against sequential steps, synced BatchNorm, the state
    broadcast."""
    import torch

    from space_time_pde_torch.models.unet3d import set_norm_group
    from space_time_pde_torch.parallel.dp import (
        batch_block, make_dp_multi_step, make_dp_train_step, make_mesh,
        replicate_state)
    from space_time_pde_torch.train import (
        init_state, make_loss_fn, make_optimizer)
    from space_time_pde_torch.utils.config import Config

    mesh = make_mesh(world, 1)
    out = {}
    for tag in ("gn", "bn"):
        batch = {k: arrays[k] for k in ("lres", "point_coord",
                                         "point_value")}
        batch["lres"] = arrays.get(f"{tag}_lres", batch["lres"])
        block = {k: _t(v) for k, v in
                 batch_block(batch, mesh.data_index, world).items()}
        cfg, unet, imnet, _ = _rb2d_setup(
            dict(spec, config=spec[f"config_{tag}"]), arrays)
        if tag == "bn":
            set_norm_group(unet, mesh.data_group)
        opt = make_optimizer(cfg)
        state = init_state(0, unet, imnet, opt)
        _load(unet, imnet, arrays, f"{tag}_")
        step = make_dp_train_step(make_loss_fn(cfg, unet, imnet, None), opt,
                                  mesh)
        state, m = step(state, block)
        out.update({f"{tag}_{k}": v for k, v in _grads(state).items()})
        out[f"{tag}_loss"] = np.asarray(float(m["loss"]))
        out[f"{tag}_grad_norm"] = np.asarray(float(m["grad_norm"]))
        for k, b in unet.named_buffers():
            if "running" in k:
                out[f"{tag}_stat/{k}"] = b.numpy().copy()
    # Three steps chained against three sequential steps (GroupNorm).
    cfg = Config.from_dict(spec["config_gn"])
    n_seq = arrays["seq_lres"].shape[0]
    stacked = {k: _t(batch_block({k: arrays[f"seq_{k}"]}, mesh.data_index,
                                 world, axis=1)[k])
               for k in ("lres", "point_coord", "point_value")}
    params = {}
    for how in ("seq", "multi"):
        _, unet, imnet, _ = _rb2d_setup(dict(spec, config=spec["config_gn"]),
                                        {})
        opt = make_optimizer(cfg)
        state = init_state(4, unet, imnet, opt)
        loss_fn = make_loss_fn(cfg, unet, imnet, None)
        if how == "seq":
            step = make_dp_train_step(loss_fn, opt, mesh)
            for g in range(n_seq):
                state, m = step(state, {k: v[g] for k, v in stacked.items()})
        else:
            state, m = make_dp_multi_step(loss_fn, opt, n_seq,
                                          mesh)(state, stacked)
        params[how] = {k: p.detach().numpy().copy()
                       for k, p in state.params().items()}
        out[f"{how}_loss"] = np.asarray(float(m["loss"]))
        out[f"{how}_step"] = np.asarray(state.step)
    for k in params["seq"]:
        out[f"seq/{k}"], out[f"multi/{k}"] = params["seq"][k], \
            params["multi"][k]
    # replicate_state: rank 1 starts from another seed.
    _, unet, imnet, _ = _rb2d_setup(dict(spec, config=spec["config_gn"]), {})
    opt = make_optimizer(cfg)
    state = init_state(100 + rank, unet, imnet, opt)
    state.opt_state["count"] = 7 * (rank + 1)
    state = replicate_state(state, mesh)
    out["replicated"] = torch.cat([p.detach().reshape(-1) for p in
                                   state.params().values()]).numpy()
    out["replicated_count"] = np.asarray(state.opt_state["count"])
    return out


def target_dp_sp(rank, world, arrays, spec):
    """parallel/dp_sp.py on a 2 x 2 world: rb2d with the replicated and
    the sharded encoder (l2 / l2 and l1 / huber), and the 4-D step with
    both encoders. Each run's reduced gradients and metrics."""
    from space_time_pde_torch.parallel.dp import make_mesh
    from space_time_pde_torch.parallel.dp_sp import (
        dp_sp_block, make_dp_sp_loss_fn, make_dp_sp_train_step)
    from space_time_pde_torch.parallel.sharded_unet import ShardedUNet3d
    from space_time_pde_torch.parallel.sharded_unet4d import ShardedUNet4d
    from space_time_pde_torch.train import init_state, make_optimizer

    n_space = spec["n_space"]
    mesh = make_mesh(world // n_space, n_space)
    out = {}
    for run in spec["runs"]:
        tag, fam, sharded = run["tag"], run["family"], run["sharded"]
        sub = {k[len(fam) + 1:]: v for k, v in arrays.items()
               if k.startswith(fam + "/")}
        cfg, unet, imnet, pde = _rb2d_setup(
            dict(spec[fam], config=run["config"]), sub)
        opt = make_optimizer(cfg)
        state = init_state(0, unet, imnet, opt)
        _load(unet, imnet, sub)
        enc = unet
        if sharded:
            cls = ShardedUNet3d if fam == "rb2d" else ShardedUNet4d
            enc = cls.from_plain(unet, mesh)
        loss_fn = make_dp_sp_loss_fn(cfg, enc, imnet, pde, mesh, sharded)
        step = make_dp_sp_train_step(loss_fn, opt, mesh)
        batch = {k: sub[f"sp/{k}"] for k in
                 ("lres", "point_coord", "point_value", "point_mask")}
        block = {k: _t(v) for k, v in
                 dp_sp_block(batch, mesh, sharded).items()}
        state, m = step(state, block)
        out.update({f"{tag}_{k}": v for k, v in _grads(state).items()})
        out.update({f"{tag}_m/{k}": np.asarray(float(v))
                    for k, v in m.items()})
    return out


def target_multihost(rank, world, arrays, spec):
    """init_multihost through the STPDE_* variables, then one SGD step of
    a linear model on this process's rows, gradients all-reduced."""
    import torch

    from space_time_pde_torch.parallel.dp import make_grad_sync, make_mesh

    mesh = make_mesh(world, 1)
    rng = np.random.RandomState(rank)
    x = torch.from_numpy(rng.randn(2, 3).astype(np.float32))
    y = torch.from_numpy(rng.randn(2, 1).astype(np.float32))
    w = torch.zeros(3, 1, requires_grad=True)
    loss = torch.mean((x @ w - y) ** 2)
    loss.backward()
    grads, metrics = {"w": w.grad}, {"loss": loss.detach()}
    make_grad_sync(mesh.data_group, world, average=True)(grads, metrics)
    with torch.no_grad():
        w_new = w - 0.1 * grads["w"]
    return {"w": w_new.numpy().ravel(), "loss": metrics["loss"].numpy()}


TARGETS = {"halo": target_halo, "sharded_unet": target_sharded_unet,
           "dp": target_dp, "dp_sp": target_dp_sp,
           "multihost": target_multihost}


def main():
    name, workdir = sys.argv[1], sys.argv[2]
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    from space_time_pde_torch.parallel.dp import init_multihost

    rank, world = init_multihost("cpu")
    arrays, spec = _inputs(workdir)
    out = TARGETS[name](rank, world, arrays, spec)
    np.savez(os.path.join(workdir, f"out_{rank}.npz"), **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

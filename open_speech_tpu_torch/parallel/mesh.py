"""The ("data", "model") device mesh and whisper's tensor-parallel rules.

Counterpart of ``open_speech_tpu/parallel/mesh.py``. The JAX package
places one program's arrays over a mesh of devices and GSPMD inserts the
collectives; PyTorch runs one process per rank, so the mesh here is a
``DeviceMesh`` over the initialised process group
(``parallel/distributed.py``) and each rank holds its own shard:

  - the model axis shards whisper Megatron-style: q, k, v and mlp_in by
    output columns (heads, MLP hidden units), o and mlp_out by input rows;
    a row-parallel product is all-reduced over the model group
    (``models/whisper/model.py:linear``);
  - the data axis carries the batch (``batch_shard``): replicas for
    serving, the gradient average for training (``train.py``).

Without a group and a mesh nothing changes: a model that ``shard_model``
never saw runs unsharded.
"""

from __future__ import annotations

import torch
from torch import nn

from open_speech_tpu_torch.models.whisper.model import Whisper

_COL = ("q", "k", "v", "mlp_in")  # sharded by output (dim 0 of [out, in])
_ROW = ("o", "mlp_out")  # sharded by input (dim 1)

_meshes: dict[tuple[int, int], object] = {}


def build_mesh(n_devices: int | None = None, data: int | None = None,
               model: int | None = None):
    """A ("data", "model") ``DeviceMesh`` over the process group: one rank
    per device, ranks laid out data-major as the JAX package lays out its
    devices.

    Defaults: every rank on the data axis (pure data parallelism). The mesh
    spans the whole group, so ``n_devices`` (when given) must be the world
    size; ``data`` x ``model`` must equal it.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs a process group: set OS_DIST_* (maybe_init_distributed) "
            "or launch with torchrun and OS_DIST_AUTO=1"
        )
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"requested n_devices={n} but the process group has {world} rank(s)")
    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


def parse_mesh(spec: str) -> tuple[int, int]:
    """``OS_TPU_MESH``'s "d,m" as (data, model)."""
    d, m = (int(x) for x in spec.split(","))
    return d, m


def mesh_from_settings():
    """The mesh ``OS_TPU_MESH`` names ("d,m"), or all ranks on the data
    axis when it is empty. One mesh per shape per process: building one
    is a collective over the group."""
    from open_speech_tpu_torch.config import settings

    spec = (settings.os_tpu_mesh or "").strip()
    key = parse_mesh(spec) if spec else (0, 0)
    if key not in _meshes:
        _meshes[key] = build_mesh(data=key[0], model=key[1]) if spec else build_mesh()
    return _meshes[key]


# ── whisper sharding rules ─────────────────────────────────────────────


def spec_for_path(name: str) -> int | None:
    """The sharded dim of one parameter or buffer of a port ``Whisper``,
    keyed by its ``named_parameters``/``named_buffers`` name; None means
    replicated. JAX's ``_spec_for_path`` transposed to ``nn.Linear``'s
    [out, in]: its output-sharded [in, out] weights shard dim 0 here.

      q/k/v/mlp_in weight, bias, int8 ``q`` and ``s`` [out]  -> 0
      o/mlp_out weight and int8 ``q``                        -> 1
      o/mlp_out bias and ``s``; embeddings, norms, convs     -> None
    """
    parts = name.split(".")
    if len(parts) < 2:
        return None
    owner, leaf = parts[-2:]  # the int8 token embedding's ``q``/``s`` have owner tok_emb
    if owner in _COL:
        return 0 if leaf in ("weight", "bias", "q", "s") else None
    if owner in _ROW:
        return 1 if leaf in ("weight", "q") else None
    return None


def _linears(model: Whisper):
    """(kind, linear) for every linear the rules shard."""
    for blk in (*model.encoder.blocks, *model.decoder.blocks):
        for attn in (blk.attn, getattr(blk, "cross", None)):
            if attn is None:
                continue
            for name in ("q", "k", "v", "o"):
                yield ("col" if name in _COL else "row"), getattr(attn, name)
        yield "col", blk.mlp_in
        yield "row", blk.mlp_out


@torch.no_grad()
def shard_model(model: Whisper, mesh) -> Whisper:
    """Keep this rank's model-axis share of every sharded tensor, in place,
    and record the model group on the model and its linears. Returns
    ``model``.

    A model axis of 1 leaves the model whole (data replicas hold all of
    it). An int8 model is quantized before it is sharded: each scale is
    taken over a whole row, as the JAX package's are.
    """
    m = mesh["model"].size()
    if m == 1:
        return model
    if model.tp_size != 1:
        raise ValueError("the model is sharded already")
    for what, heads in (("n_audio_head", model.encoder.n_head),
                        ("n_text_head", model.decoder.n_head)):
        if heads % m:
            raise ValueError(f"{what}={heads} not divisible by model-axis size {m}")
    rank = mesh.get_local_rank("model")
    group = mesh.get_group("model")
    tensors = [(n, t, True) for n, t in model.named_parameters()]
    tensors += [(n, t, False) for n, t in model.named_buffers()]
    for name, t, is_param in tensors:
        dim = spec_for_path(name)
        if dim is None:
            continue
        size = t.shape[dim] // m
        share = t.narrow(dim, rank * size, size).clone(memory_format=torch.contiguous_format)
        owner_name, leaf = name.rsplit(".", 1)
        owner = model.get_submodule(owner_name)
        if is_param:
            setattr(owner, leaf, nn.Parameter(share, requires_grad=t.requires_grad))
        else:
            owner._buffers[leaf] = share
    for kind, lin in _linears(model):
        if isinstance(lin, nn.Linear):
            lin.out_features, lin.in_features = lin.weight.shape
        lin.tp = (kind, group)
    model.tp_group = group
    model.tp_size = m
    return model


def batch_shard(x: torch.Tensor, mesh) -> torch.Tensor:
    """This data rank's share of ``x``'s dim 0 (the batch), as the JAX
    package's ``batch_sharding`` places it."""
    d = mesh["data"].size()
    b = x.shape[0]
    if b % d:
        raise ValueError(f"batch {b} not divisible by data-axis size {d}")
    r = mesh.get_local_rank("data")
    return x[r * (b // d):(r + 1) * (b // d)]

"""State carried across from the JAX package.

:func:`uhierarchy_from_numpy` builds the port's :class:`UHierarchy` and
:func:`hierarchy_from_numpy` the structured :class:`Hierarchy` from plain
numpy/scipy data, exactly what ``np.asarray`` pulls out of the JAX
package's hierarchies, and :func:`partitioned_ell_from_numpy` the
row-partitioned :class:`PartitionedELL` from a JAX one's arrays.
:func:`fullaggnet_from_params` loads a
checkpoint's learned weights into the port's :class:`FullAggNet` and
:func:`cfnet_from_params` into its :class:`CFInterpolationNetwork`;
:func:`params_from_fullaggnet` and :func:`params_from_cfnet` write them back
as the JAX package's parameter tree.  :func:`module_from_params` and
:func:`params_from_module` do the same for any other of the port's flax-named
modules (``ConvergencePredictor``, ``AggOnlyNet``, the interpolation
networks), built by the caller.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from mlamg_torch.device import resolve_device
from mlamg_torch.mg.amg_unstructured import UHierarchy, _make_level
from mlamg_torch.mg.coarse import CoarseSolver
from mlamg_torch.mg.cycle import Hierarchy
from mlamg_torch.mg.factored import BilinearP2D, BoxAgg2D, FactoredSA
from mlamg_torch.models.agg_interp import FullAggNet
from mlamg_torch.models.cf_interp import CFInterpolationNetwork
from mlamg_torch.models.gnn import Dense, LayerNorm
from mlamg_torch.ops.dia import DIA
from mlamg_torch.parallel.pspmv import PartitionedELL


def uhierarchy_from_numpy(levels: Sequence[Mapping], coarse: Mapping, *,
                          fmt: str, device=None, block_rows: int = 8) -> UHierarchy:
    """Port hierarchy from host data.

    ``levels``: per level a mapping with the scipy operator ``A`` and
    ``Dinv``, ``agg``, ``omegas``, ``lmax``, ``k``.  ``coarse``: ``lu``,
    ``piv`` (0-based, as JAX and scipy return them), ``singular`` and
    ``method``.  ``fmt`` is ``"well"`` or ``"csr"``.
    """
    dev = resolve_device(device)
    ulevels = tuple(_make_level(lev, fmt, block_rows, dev) for lev in levels)
    return UHierarchy(ulevels, _coarse_from_numpy(coarse, dev, np.float32))


def partitioned_ell_from_numpy(data, col, shape, num_shards: int, halo: int | None,
                               device=None) -> PartitionedELL:
    """The port's PartitionedELL from a JAX one's ``data`` (S, n_loc, w),
    ``col`` (int32, widened to int64), ``shape``, ``num_shards`` and
    ``halo``."""
    dev = resolve_device(device)
    data, col = np.asarray(data), np.asarray(col)
    if data.shape != col.shape or data.shape[0] != num_shards:
        raise ValueError(f"data {data.shape} and col {col.shape} are not {num_shards} shards")
    return PartitionedELL(torch.tensor(data, device=dev),
                          torch.tensor(col, dtype=torch.int64, device=dev),
                          tuple(int(v) for v in shape), int(num_shards),
                          None if halo is None else int(halo))


def _coarse_from_numpy(coarse: Mapping, device, dtype=None) -> CoarseSolver:
    """CoarseSolver from ``lu`` (the inverse for ``method="inverse"``),
    ``piv`` (0-based, as JAX and scipy return them), ``singular`` and
    ``method``; ``lu`` in ``dtype`` (default: its own)."""
    method = str(coarse["method"])
    lu = torch.tensor(np.asarray(coarse["lu"], dtype), device=device)
    if method == "lu":
        # LAPACK (and so torch) pivots are 1-based
        piv = torch.tensor(np.asarray(coarse["piv"], np.int32) + 1, device=device)
    else:
        piv = torch.zeros(0, dtype=torch.int32, device=device)
    return CoarseSolver(lu, piv, bool(coarse["singular"]), method)


def _dia_from_numpy(m: Mapping, device) -> DIA:
    """DIA from ``data`` ((D, n), or the JAX package's blocked
    (D, n/128, 128), which is flattened), ``offsets`` and ``shape``."""
    offsets = tuple(int(o) for o in m["offsets"])
    shape = tuple(int(s) for s in m["shape"])
    data = np.asarray(m["data"]).reshape(len(offsets), shape[0])
    return DIA(torch.tensor(data, device=device), offsets, shape)


def _prolongator_from_numpy(m: Mapping, device):
    """``{"ny", "nx"}`` is a :class:`BilinearP2D`; ``{"Ss", "Sts", "T"}``
    with DIA mappings and ``T = {"ny", "nx", "sy", "sx"}`` a
    :class:`FactoredSA` over a :class:`BoxAgg2D`."""
    if "Ss" not in m:
        return BilinearP2D(ny=int(m["ny"]), nx=int(m["nx"]))
    T = BoxAgg2D(**{k: int(m["T"][k]) for k in ("ny", "nx", "sy", "sx")})
    return FactoredSA(tuple(_dia_from_numpy(S, device) for S in m["Ss"]),
                      tuple(_dia_from_numpy(S, device) for S in m["Sts"]), T)


def hierarchy_from_numpy(As: Sequence[Mapping], Ps: Sequence[Mapping],
                         Dinvs: Sequence, lmaxs: Sequence, coarse: Mapping, *,
                         device=None) -> Hierarchy:
    """Structured hierarchy from host data, in the data's own float type.

    ``As``: per level a DIA mapping (``data``, ``offsets``, ``shape``).
    ``Ps``: per level a prolongator mapping (see
    :func:`_prolongator_from_numpy`).  ``Dinvs`` and ``lmaxs``: per level
    the inverse diagonal and the spectrum bound.  ``coarse``: ``lu`` (the
    inverse for ``method="inverse"``), ``piv`` (0-based), ``singular`` and
    ``method`` (see :func:`_coarse_from_numpy`).
    """
    dev = resolve_device(device)
    return Hierarchy(
        tuple(_dia_from_numpy(A, dev) for A in As),
        tuple(_prolongator_from_numpy(P, dev) for P in Ps),
        tuple(torch.tensor(np.asarray(d), device=dev) for d in Dinvs),
        _coarse_from_numpy(coarse, dev),
        tuple(float(v) for v in lmaxs),
    )


def _flat_params(tree: Mapping, prefix: str = "") -> dict:
    """{"a/b/kernel": array} from a nested mapping of numpy arrays."""
    out = {}
    for name, v in tree.items():
        path = f"{prefix}/{name}" if prefix else name
        out.update(_flat_params(v, path) if isinstance(v, Mapping) else {path: v})
    return out


def _torch_key(path: str) -> str:
    """flax path -> state_dict key: Dense ``kernel`` -> ``weight`` (taken
    transposed), LayerNorm ``scale`` -> ``weight``."""
    *mods, leaf = path.split("/")
    return ".".join(mods + [{"kernel": "weight", "scale": "weight"}.get(leaf, leaf)])


def fullaggnet_from_params(params: Mapping, net_config: Mapping, device=None,
                           dtype=torch.float32) -> FullAggNet:
    """The port's :class:`FullAggNet` with a checkpoint's weights.

    ``params`` is a checkpoint's ``best_params``: ``{"params": {"AggNetM":
    ..., "CNet": ..., "PNet": ...}}`` of numpy arrays.  ``net_config``
    holds ``dim``, ``num_conv``, ``iterations``, ``bf_width`` and
    ``rel_strength``.  A flax Dense ``kernel`` (in, out) becomes
    ``Linear.weight`` (out, in); LayerNorm ``scale``/``bias`` become
    ``weight``/``bias``.  A missing or unknown key, or a shape that does not
    fit, raises.
    """
    dev = resolve_device(device)
    bf_width = net_config.get("bf_width")
    net = FullAggNet(dim=int(net_config["dim"]), num_conv=int(net_config["num_conv"]),
                     iterations=int(net_config["iterations"]),
                     bf_width=None if bf_width is None else int(bf_width),
                     rel_strength=bool(net_config.get("rel_strength", False)))
    _load_flax_params(net, params, "fullaggnet_from_params")
    return net.to(device=dev, dtype=dtype).eval()


def cfnet_from_params(params: Mapping, net_config: Mapping | None = None, device=None,
                      dtype=torch.float32) -> CFInterpolationNetwork:
    """The port's :class:`CFInterpolationNetwork` with the weights of a
    checkpoint's ``best_params`` (``{"params": {"model": ...}}``, numpy
    arrays), mapped as :func:`fullaggnet_from_params` maps them.
    ``net_config`` (a checkpoint's ``extra["net_config"]``) holds ``dims``,
    ``K`` and ``row_normalize``; without it the network's defaults."""
    dev = resolve_device(device)
    nc = net_config or {}
    net = CFInterpolationNetwork(**({"dims": tuple(nc["dims"]), "K": int(nc["K"]),
                                     "row_normalize": bool(nc["row_normalize"])} if nc else {}))
    _load_flax_params(net, params, "cfnet_from_params")
    return net.to(device=dev, dtype=dtype).eval()


def module_from_params(net: torch.nn.Module, params: Mapping, device=None,
                       dtype=torch.float32) -> torch.nn.Module:
    """``net`` (a port module with the flax submodule names, built by the
    caller with the JAX module's configuration) with the weights of a
    flax parameter tree ``{"params": {...}}`` of numpy arrays, moved to
    ``device`` and ``dtype``; mapped and checked as in
    :func:`fullaggnet_from_params`."""
    dev = resolve_device(device)
    _load_flax_params(net, params, type(net).__name__)
    return net.to(device=dev, dtype=dtype)


def params_from_module(net: torch.nn.Module) -> dict:
    """The JAX package's parameter tree of a port module; the inverse of
    :func:`module_from_params`."""
    return _flax_params(net)


def _load_flax_params(net, params: Mapping, who: str) -> None:
    """Load a flax parameter tree into ``net``: a Dense ``kernel`` (in, out)
    becomes ``weight`` (out, in), a LayerNorm ``scale`` ``weight``.  A
    missing or unknown key, or a shape that does not fit, raises."""
    state = {}
    for path, value in _flat_params(params["params"]).items():
        value = np.asarray(value)
        state[_torch_key(path)] = torch.from_numpy(
            np.ascontiguousarray(value.T if path.endswith("/kernel") else value))
    expected = net.state_dict()
    missing = sorted(set(expected) - set(state))
    unknown = sorted(set(state) - set(expected))
    if missing or unknown:
        raise ValueError(f"{who}: missing {missing}, unknown {unknown}")
    bad = [k for k, v in state.items() if v.shape != expected[k].shape]
    if bad:
        raise ValueError(f"{who}: shapes differ for {bad}")
    net.load_state_dict(state)


def param_leaves(net) -> list:
    """[(flax path, parameter, is_kernel)] of a module in flax's tree order
    (the paths sorted, as ``jax.tree`` orders a dict's keys): a Dense
    ``weight`` is the flax ``kernel`` (taken transposed), a LayerNorm
    ``weight`` its ``scale``."""
    out = []
    for name, m in net.named_modules():
        prefix = ("params", *name.split(".")) if name else ("params",)
        if isinstance(m, Dense):
            out.append((prefix + ("kernel",), m.weight, True))
            if m.bias is not None:
                out.append((prefix + ("bias",), m.bias, False))
        elif isinstance(m, LayerNorm):
            out += [(prefix + ("scale",), m.weight, False), (prefix + ("bias",), m.bias, False)]
    return sorted(out, key=lambda leaf: leaf[0])


def params_from_fullaggnet(net) -> dict:
    """The JAX package's parameter tree ``{"params": {"AggNetM": ...,
    "CNet": ..., "PNet": ...}}`` of numpy arrays, from a port module; the
    inverse of :func:`fullaggnet_from_params`."""
    return _flax_params(net)


def params_from_cfnet(net) -> dict:
    """The JAX package's parameter tree ``{"params": {"model": ...}}`` of a
    :class:`CFInterpolationNetwork`; the inverse of :func:`cfnet_from_params`."""
    return _flax_params(net)


def _flax_params(net) -> dict:
    tree: dict = {}
    for path, p, is_kernel in param_leaves(net):
        value = p.detach().cpu().numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(value.T if is_kernel else value)
    return tree

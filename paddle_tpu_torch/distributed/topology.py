"""Hybrid-parallel topology over ``torch.distributed`` ranks (a port of
``paddle_tpu/distributed/topology.py``).

The reference lays the chips out as a ``jax.sharding.Mesh`` with named
axes and names each collective's group by its axis. The port lays the
processes out the same way: :func:`build_mesh` returns a :class:`Mesh`
(``.shape``, ``.axis_names``, ``.ranks``), the global ranks in the
reference's axis order (outer to inner) ``pp, dp, sharding, sp, mp``,
so neighbouring ``mp`` ranks are neighbouring processes, as the
reference puts them on neighbouring chips. ``HybridCommunicateGroup``
makes, for each axis, the ``torch.distributed.new_group`` of the ranks
along it through this rank (every process makes every group, in one
order, as ``new_group`` requires), and reports this rank's coordinate on
each axis.
"""
import numpy as np

from . import env

_HYBRID = None  # the HybridCommunicateGroup last built

AXES = ("pp", "dp", "sharding", "sp", "mp")


class Mesh:
    """The global ranks laid out on named axes: ``ranks`` a numpy array
    of shape ``[pp, dp, sharding, sp, mp]`` (with :data:`AXES`),
    ``shape`` the axis sizes by name, as ``jax.sharding.Mesh.shape``
    gives them."""

    def __init__(self, ranks, axis_names=AXES):
        self.ranks = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.ranks.shape))

    @property
    def devices(self):
        return self.ranks

    @property
    def size(self):
        return int(self.ranks.size)

    def coord(self, rank):
        """``{axis: index}`` of global ``rank``."""
        where = np.argwhere(self.ranks == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh {self.shape}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_groups(self, axis):
        """Every group of ranks along ``axis`` (one for each setting of
        the other axes), each in the axis's order."""
        a = self.axis_names.index(axis)
        moved = np.moveaxis(self.ranks, a, -1)
        return [[int(r) for r in row]
                for row in moved.reshape(-1, self.ranks.shape[a])]

    def __repr__(self):
        return f"Mesh({self.shape})"


def build_mesh(dp=1, mp=1, pp=1, sharding=1, sp=1, world_size=None):
    """The mesh of ``world_size`` ranks (the process group's by
    default); degrees that multiply to 1 make it all ``dp``, as the
    reference's does."""
    world = env.get_world_size() if world_size is None else int(world_size)
    need = dp * mp * pp * sharding * sp
    if need != world:
        if need == 1:
            dp = need = world
        else:
            raise ValueError(
                f"product of parallel degrees {need} != world size "
                f"{world}")
    return Mesh(np.arange(world).reshape(pp, dp, sharding, sp, mp))


class HybridCommunicateGroup:
    """The reference's accessors of each axis's degree, group and this
    rank's place on it (reference topology.py:117)."""

    def __init__(self, strategy=None, mesh=None, dp=1, mp=1, pp=1,
                 sharding=1, sp=1):
        from . import collective
        if strategy is not None:
            hc = strategy.hybrid_configs
            dp = hc.get("dp_degree", 1)
            mp = hc.get("mp_degree", 1)
            pp = hc.get("pp_degree", 1)
            sharding = hc.get("sharding_degree", 1)
            sp = hc.get("sp_degree", hc.get("sep_degree", 1))
        self.mesh = mesh if mesh is not None else build_mesh(
            dp=dp, mp=mp, pp=pp, sharding=sharding, sp=sp)
        self.global_rank = env.get_rank()
        self._coord = self.mesh.coord(self.global_rank)
        self._groups = {}
        for axis in AXES:   # one order on every rank
            for ranks in self.mesh.axis_groups(axis):
                g = collective.new_group(ranks, axis=axis)
                if self.global_rank in ranks:
                    self._groups[axis] = g
        global _HYBRID
        _HYBRID = self

    def _size(self, axis):
        return int(self.mesh.shape[axis])

    def group(self, axis):
        """This rank's group along ``axis`` (one of :data:`AXES`)."""
        return self._groups[axis]

    # degrees ------------------------------------------------------------
    def get_data_parallel_world_size(self):
        return self._size("dp")

    def get_model_parallel_world_size(self):
        return self._size("mp")

    def get_pipe_parallel_world_size(self):
        return self._size("pp")

    def get_sharding_parallel_world_size(self):
        return self._size("sharding")

    def get_sequence_parallel_world_size(self):
        return self._size("sp")

    # groups ---------------------------------------------------------------
    def get_data_parallel_group(self):
        return self._groups["dp"]

    def get_model_parallel_group(self):
        return self._groups["mp"]

    def get_pipe_parallel_group(self):
        return self._groups["pp"]

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    def get_sequence_parallel_group(self):
        return self._groups["sp"]

    # this rank's place ----------------------------------------------------
    def get_global_rank(self):
        return self.global_rank

    def get_data_parallel_rank(self):
        return self._coord["dp"]

    def get_model_parallel_rank(self):
        return self._coord["mp"]

    def get_sharding_parallel_rank(self):
        return self._coord["sharding"]

    def get_sequence_parallel_rank(self):
        return self._coord["sp"]

    def get_stage_id(self):
        return self._coord["pp"]

    def get_rank_from_stage(self, stage_id, **kwargs):
        """The global rank at pipeline stage ``stage_id`` with this
        rank's other coordinates (``kwargs`` overrides some)."""
        c = dict(self._coord, pp=stage_id, **kwargs)
        return int(self.mesh.ranks[tuple(c[a] for a in AXES)])

    def topology(self):
        return self.mesh


def get_hybrid_communicate_group():
    return _HYBRID


_SOLO = {}


def axis_group(axis, group=None):
    """``group``, else the current hybrid topology's group of ``axis``,
    else a group of this rank alone (every collective over it the
    identity, as the reference's eager tensor-parallel ops are outside a
    mesh)."""
    if group is not None:
        return group
    if _HYBRID is not None:
        return _HYBRID.group(axis)
    from .collective import Group
    key = (env.get_rank(), axis)
    if key not in _SOLO:
        _SOLO[key] = Group([key[0]], axis=axis)
    return _SOLO[key]


def get_mesh():
    if _HYBRID is not None:
        return _HYBRID.mesh
    return None


def set_mesh(mesh):
    """Make a HybridCommunicateGroup over ``mesh`` the current one."""
    return HybridCommunicateGroup(mesh=mesh)


def reset():
    """Forget the current HybridCommunicateGroup (a new ``fleet.init``
    or a test starts over)."""
    global _HYBRID
    _HYBRID = None


class CommunicateTopology:
    """Reference: topology.py:36 — cartesian coordinate helper."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = None
        self._world = int(np.prod(dims))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    def world_size(self):
        return self._world

    def get_rank(self, **kwargs):
        coord = [kwargs[n] for n in self._parallel_names]
        return int(np.ravel_multi_index(coord, self._dims))

    def get_coord(self, rank):
        return tuple(int(c) for c in np.unravel_index(rank, self._dims))

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return [r for r in range(self._world)
                if self.get_coord(r)[axis] == index]

    def get_dim_size(self, axis_name):
        return self.get_dim(axis_name)

    def get_comm_list(self, axis_name):
        axis = self._parallel_names.index(axis_name)
        others = [i for i in range(len(self._dims)) if i != axis]
        comm_list = []
        for combo in np.ndindex(*[self._dims[i] for i in others]):
            group = []
            for k in range(self._dims[axis]):
                coord = [0] * len(self._dims)
                for i, o in enumerate(others):
                    coord[o] = combo[i]
                coord[axis] = k
                group.append(int(np.ravel_multi_index(coord, self._dims)))
            comm_list.append(group)
        return comm_list

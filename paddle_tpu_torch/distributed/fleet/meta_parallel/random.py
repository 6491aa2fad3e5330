"""RNG state tracking for tensor parallelism (a port of
``paddle_tpu/distributed/fleet/meta_parallel/random.py``).

Reference parallel_layers/random.py:24 ``RNGStatesTracker``: named
random streams, so that dropout on activations that every ``mp`` rank
holds whole draws the same mask on every rank (each rank seeds the
stream with the same seed), while other streams differ by rank. The
reference's single controller draws one mask for every shard; the port's
ranks are processes, so the streams are explicit ``torch.Generator``s.
Inside ``rng_state(name)`` the stream stands in for the port's default
generator of its device (``core.rng.default_generator``), which dropout
draws from when it is given no generator of its own.
"""
from contextlib import contextmanager

import torch

from ....core import rng as rng_mod
from ....core.device import resolve_device

MODEL_PARALLEL_RNG = "model_parallel_rng"


class RNGStatesTracker:
    def __init__(self):
        self.reset()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()
        self.devices_ = {}

    def add(self, name, seed, device=None):
        """A stream ``name`` seeded with ``seed`` on ``device`` (the
        current device by default)."""
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already added")
        if name in self.states_:
            raise ValueError(f"state {name} already added")
        self.seeds_.add(seed)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self.states_[name] = gen
        self.devices_[name] = dev

    def get_states_tracker(self):
        return {k: g.get_state() for k, g in self.states_.items()}

    def set_states_tracker(self, states):
        for k, s in states.items():
            self.states_[k].set_state(s)

    @contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} not added")
        gen, dev = self.states_[name], self.devices_[name]
        prev = rng_mod.default_generator(dev)
        rng_mod._generators[dev] = gen
        try:
            yield gen
        finally:
            rng_mod._generators[dev] = prev


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed=None, device=None):
    import random
    seed = seed or (random.randint(0, 1 << 30))
    _RNG_STATE_TRACKER.reset()
    _RNG_STATE_TRACKER.add(MODEL_PARALLEL_RNG, seed, device)

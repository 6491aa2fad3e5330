"""Command-line tools of the port's serving fleet (ports of the
reference's ``tools/router_drill.py``, ``tools/chaos_sweep.py`` and
``tools/fleet_top.py``, and of ``tests/router_replica_worker.py``). Run
each as ``python -m paddle_tpu_torch.tools.<name>`` from the directory
that holds the package."""

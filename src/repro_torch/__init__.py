"""PyTorch port of the FedSPD reproduction, for NVIDIA Hopper (H100).

A package beside the JAX reference ``repro``, module for module under the
same paths. It imports ``torch`` and numpy only — never ``jax`` and nothing
of ``repro``. Entry point::

    from repro_torch.experiments import RunConfig, run_method
    run_method("fedspd", data, exp, cfg=RunConfig(gossip_backend="cuda"))

Runs on the card by default (``RunConfig.device="cuda"``); without one it
raises unless the caller asks for ``device="cpu"``.
"""

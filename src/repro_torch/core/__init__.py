"""Host model of the paper (platforms, strategies, traces) and the device
lane machine :func:`repro_torch.core.torch_sim.simulate_batch_torch`."""

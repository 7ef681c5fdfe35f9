"""repro_torch.serve — batched bit-fluid CNN serving on one device."""

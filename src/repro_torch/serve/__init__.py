"""repro_torch.serve — batched bit-fluid CNN serving and whole-batch LM
generation on one device."""

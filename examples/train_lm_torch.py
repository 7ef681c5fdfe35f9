"""End-to-end training example on the PyTorch port: a qwen3-family LM on
the synthetic pipeline with checkpointing and the straggler watchdog
(the counterpart of ``examples/train_lm.py``).

Defaults are CPU-friendly (the SMOKE model, 60 steps, minutes on the
CPU); pass ``--full`` for the ~100M-parameter, 300-step configuration on
a GPU:

  PYTHONPATH=src python examples/train_lm_torch.py --device cpu
  PYTHONPATH=src python examples/train_lm_torch.py --full
"""
import argparse
import os
import tempfile

from repro_torch.launch import train as train_mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M params, 300 steps (GPU-sized)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    args = ap.parse_args()
    if args.full:
        # ~100M params: 12L x d=768 (qwen3 family), seq 512
        import repro_torch.configs.qwen3_4b as q
        q.SMOKE = q.FULL.with_(
            n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
            vocab_size=32000, head_dim=64, remat="none")
        argv = ["--steps", "300", "--batch", "16", "--seq", "512",
                "--ckpt-dir", args.ckpt_dir + "_full"]
    else:
        argv = ["--steps", "60", "--batch", "8", "--seq", "128",
                "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "25",
                "--wbits", "8", "4"]
    train_mod.main(["--arch", "qwen3_4b", "--smoke", "--device",
                    args.device, "--abits", "8"] + argv)


if __name__ == "__main__":
    main()

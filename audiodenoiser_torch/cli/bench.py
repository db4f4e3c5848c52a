"""Console entry point of the throughput bench (``eval.bench``).

  python -m audiodenoiser_torch.cli.bench [--width_mult 0.25] [--no_train]
"""

from audiodenoiser_torch.eval.bench import main

if __name__ == "__main__":
    main()

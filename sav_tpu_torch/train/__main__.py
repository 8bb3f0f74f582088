"""``python -m sav_tpu_torch.train``: see :func:`sav_tpu_torch.train.main`."""

from sav_tpu_torch.train import main

if __name__ == "__main__":
    main()

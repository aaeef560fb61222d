"""The port's command-line entry points, run as
``python -m tvqvae_tpu_torch.scripts.<name>``: ``train``, ``train_fcn``,
``generate`` and ``serve``, with the JAX package's flags."""

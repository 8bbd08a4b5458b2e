"""Command-line tools of the port, each run as ``python -m
vae_channel_dynamics_tpu_torch.tools.<name>``: ``profile_summary`` (a
Trainer's profiler trace by kernel family), ``report`` and ``compare_runs``
(run directories to markdown), ``serving_bench`` (an HTTP load client for
``server.py``), ``convert_diffusers`` (model directories), ``doctor``
(the environment's self-check), ``loader_bench`` (the input pipeline's
images/s, PIL against native) and ``export_model`` (``torch.export``
programs of the inference entry points)."""

"""Command-line tools of the port, each run as
``python -m spmv_research_tpu_torch.tools.<name>``: the counterparts of the
JAX repository's ``tools/`` scripts (``collect_results``,
``create_param_file``, ``mat_feat``, ``machine_info``, ``twin_fidelity``,
``locality_stats``, ``xl_run``, ``multiproc_cpu_test``, ``weak_scaling``,
and ``launch_multihost`` for the shell launcher), on the port's modules."""

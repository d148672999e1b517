"""The port's command lines, each ``python -m peanut_tpu_torch.cli.<name>``
and a ``main(argv)``: collect, collect_maps, eval, train_prediction_model,
test, serve and benchmark; the zoo's tools: convert (weights and
datasets, with the walkers of convert_datasets), export (``torch.export``)
and tools (print_config, analyze_logs, confusion_matrix, browse_dataset,
collect_env)."""

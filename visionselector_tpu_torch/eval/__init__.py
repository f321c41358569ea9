"""The evaluation harness: task registry, metrics, filters, the response
cache, the results tracker, EVAL_TIME scraping, log replay and selection
visualizations, and the tools ``lite`` (k-center subsets) and
``export_tasks`` (HF releases into the harness's jsonl), are copies of
the JAX package's ``eval`` modules (the port
loads no module of it; ``tests/test_torch_eval_modules.py`` and
``test_torch_eval_tools.py`` hold each copy equal to its original). One difference: ``tasks.load_task_configs``
imports ``yaml`` only when it reads a YAML file, so JSON task files load
where PyYAML is not installed. ``evaluator`` drives the port's engine."""

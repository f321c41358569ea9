"""The evaluation harness: task registry, metrics, filters, the response
cache, the results tracker, EVAL_TIME scraping, log replay and selection
visualizations are copies of the JAX package's ``eval`` modules (the port
loads no module of it; ``tests/test_torch_eval_modules.py`` holds each
copy equal to its original). One difference: ``tasks.load_task_configs``
imports ``yaml`` only when it reads a YAML file, so JSON task files load
where PyYAML is not installed. ``evaluator`` drives the port's engine."""

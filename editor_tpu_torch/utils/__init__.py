"""utils of the editor_tpu_torch port: checkpoints, weight conversion, logging,
visualisation, and the debugging (``debug``) and profiling (``profiling``)
aids."""

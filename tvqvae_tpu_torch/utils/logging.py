"""Experiment logging: MLflow-compatible metric names, file-backed fallback.

Port of ``tvqvae_tpu/utils/logging.py``. A ``RunLogger`` always writes JSONL
metrics and PNG artifacts under a local run directory and, when a tracking
URI is configured and ``mlflow`` imports, mirrors both to MLflow with the
same metric names (``train/loss``, ``val/loss``, ...). ``mlflow`` is imported
only then. The runners hand it 0-dim device tensors; ``float`` of one waits
for the device, so the runners call it only every ``log_interval`` steps.
"""

import json
import os
import time
from typing import Dict, Optional


class RunLogger:
    def __init__(
        self,
        run_dir: str,
        experiment_name: str = "SynTraj-TimeVQVAE-TPU",
        run_name: Optional[str] = None,
        mlflow_uri: Optional[str] = None,
    ):
        self.run_dir = os.path.abspath(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self._metrics_f = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")
        self._mlflow = None
        if mlflow_uri:
            try:
                import mlflow

                mlflow.set_tracking_uri(mlflow_uri)
                mlflow.set_experiment(experiment_name)
                self._mlflow = mlflow
                self._run = mlflow.start_run(run_name=run_name)
            except Exception as e:  # mlflow or its server absent: keep file logging only
                print(f"[logger] mlflow disabled: {e}")
                self._mlflow = None

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._metrics_f.write(json.dumps(rec) + "\n")
        self._metrics_f.flush()
        if self._mlflow:
            self._mlflow.log_metrics(
                {k.replace(":", "_"): float(v) for k, v in metrics.items()},
                step=int(step),
            )

    def log_image(self, fig, filename: str) -> None:
        """Save a matplotlib figure as an artifact."""
        path = os.path.join(self.run_dir, filename)
        fig.savefig(path, format="png", bbox_inches="tight")
        if self._mlflow:
            self._mlflow.log_artifact(path)

    def log_params(self, params: Dict) -> None:
        with open(os.path.join(self.run_dir, "params.json"), "w") as f:
            json.dump(params, f, indent=2, default=str)
        if self._mlflow:
            self._mlflow.log_params({k: str(v)[:250] for k, v in params.items()})

    def close(self) -> None:
        self._metrics_f.close()
        if self._mlflow:
            self._mlflow.end_run()

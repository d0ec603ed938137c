"""Atomic checkpoint store (counterpart of `repro.checkpoint`)."""
from repro_torch.checkpoint.store import (committed_steps, copy_study_version,
                                          drop_studies, latest_step,
                                          list_studies, prune_studies,
                                          restore, restore_latest,
                                          restore_study, save, save_study,
                                          study_dir, study_versions,
                                          sweep_tmp)
__all__ = ["committed_steps", "copy_study_version", "drop_studies",
           "latest_step", "list_studies",
           "prune_studies", "restore", "restore_latest", "restore_study",
           "save", "save_study", "study_dir", "study_versions",
           "sweep_tmp"]

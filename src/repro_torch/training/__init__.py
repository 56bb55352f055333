"""EMSNet training: losses, optimizers, checkpoints, the multitask
trainer and Progressive Modality Integration."""

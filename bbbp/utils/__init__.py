from bbbp.utils.checkpoint import save_checkpoint, restore_checkpoint

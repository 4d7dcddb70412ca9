from bbbp.train.loop import CVResult, train_multimodal_cv

__all__ = ["CVResult", "train_multimodal_cv"]

from repro_torch.train.train_step import TrainConfig, make_train_step

__all__ = ["TrainConfig", "make_train_step"]

from .train_step import TrainState, init_state, make_train_step, train_step  # noqa
from .trainer import StragglerMonitor, Trainer, TrainerConfig  # noqa

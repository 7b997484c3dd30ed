"""Training: the loop, the crop feed and checkpoints (`data.list_images`
also serves the folder modes)."""
from rusty_sr_tpu_torch.train.data import (ImageFolderSupplier,  # noqa: F401
                                           PrefetchBuffer)
from rusty_sr_tpu_torch.train.loop import (TrainConfig, loss_fn,  # noqa: F401
                                           make_train_step, train_loop)

from . import lr
from .optimizer import (ASGD, LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax,
                        AdamW, Lamb, Momentum, NAdam, Optimizer, RAdam,
                        RMSProp, Rprop)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "Adadelta", "Adamax", "RMSProp", "Lamb", "NAdam", "RAdam", "ASGD",
           "Rprop", "LBFGS"]

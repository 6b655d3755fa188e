from .serial import SerialTreeLearner, create_tree_learner

__all__ = ["SerialTreeLearner", "create_tree_learner"]

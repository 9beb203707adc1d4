from .losses import LaplacianLoss, FlattenLoss, neg_iou_loss

__all__ = ['LaplacianLoss', 'FlattenLoss', 'neg_iou_loss']

"""LeNet (a port of ``paddle_tpu/vision/models/lenet.py``): two convs
with ReLU and 2x2 max pools, then three Linear layers."""
from ... import nn
from ...ops import manipulation


class LeNet(nn.Layer):
    def __init__(self, num_classes=10):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0),
            nn.ReLU(),
            nn.MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120),
                nn.Linear(120, 84),
                nn.Linear(84, num_classes))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = manipulation.flatten(x, 1)
            x = self.fc(x)
        return x

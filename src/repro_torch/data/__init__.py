from .pipeline import FrameStub, SyntheticLMDataset, TeacherStudentDataset

__all__ = ["FrameStub", "SyntheticLMDataset", "TeacherStudentDataset"]

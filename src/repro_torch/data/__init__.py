from .pipeline import SyntheticLMDataset, TeacherStudentDataset

__all__ = ["SyntheticLMDataset", "TeacherStudentDataset"]
